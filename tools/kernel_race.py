"""Time each hand-written kernel against the plain XLA form, on the GPU.

    python tools/kernel_race.py [--only bag,aligned,engine] [--reps N] [--tiny]

Every line of output is one JSON object carrying the card's name and power
limit. Each pair is timed in turns in one process (warm-up first, then
``block_until_ready`` around every repetition; the median is reported),
and each kernel's result is compared with the XLA form's: votes must be
equal. ``--tiny`` rehearses the plumbing at toy sizes on any platform;
otherwise the tool exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def card() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    ).stdout.strip().splitlines()
    name, limit = (out[0].split(",") + [""])[:2] if out else ("?", "?")
    return {"card": name.strip(), "power_limit": limit.strip()}


CARD: dict = {}


def emit(**kw) -> None:
    print(json.dumps({**kw, **CARD}), flush=True)


def timed(fn, reps: int) -> float:
    """Median wall ms of ``fn()`` (already warm), each rep blocking."""
    import jax

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def race(label: str, contenders: dict, reps: int, check) -> dict:
    """Warm every contender, then time them in turns (a, b, b, a, ...)."""
    import jax

    outs = {}
    for name, fn in contenders.items():
        t0 = time.perf_counter()
        outs[name] = jax.block_until_ready(fn())
        emit(race=label, contender=name,
             compile_s=round(time.perf_counter() - t0, 3))
    names = list(contenders)
    times = {n: [] for n in names}
    for r in range(2):
        for n in (names if r == 0 else names[::-1]):
            times[n].append(timed(contenders[n], reps))
    res = {n: float(np.median(v)) for n, v in times.items()}
    emit(race=label, ms=res, check=check(outs))
    return res


# --------------------------------------------------------------------- #
# Matchers: Triton kernels vs match_jax.match_votes
# --------------------------------------------------------------------- #


def synth_db(n, t, c, seed=7):
    """Per-audio clustered coefficient values on device (bench.py's
    aligned-scale generator): ``(db [n, t, c], mask [n, t])``."""
    import jax
    import jax.numpy as jnp

    from tiresias_tpu.ops.mfcc_jax import PAD_VALUE

    k_mu, k_noise, k_nf = jax.random.split(jax.random.PRNGKey(seed), 3)

    @jax.jit
    def gen():
        mu = jax.random.uniform(k_mu, (n, 1, c), jnp.float32, -25.0, 20.0)
        db = mu + 1.5 * jax.random.normal(k_noise, (n, t, c), jnp.float32)
        nf = jax.random.randint(k_nf, (n,), t // 2, t)
        mask = jnp.arange(t)[None, :] < nf[:, None]
        return jnp.where(mask[:, :, None], db, PAD_VALUE), mask

    return gen()


def excerpt_queries(db, ids, f, seed=9):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    q = np.stack([np.asarray(db[i, 8:8 + f]) for i in ids])
    return jnp.asarray(q + rng.normal(0, 0.01, q.shape).astype(np.float32))


def race_matchers(reps: int, which: str, tiny: bool = False) -> None:
    import jax
    import jax.numpy as jnp

    from tiresias_tpu.ops import match_jax
    from tiresias_tpu.ops.match_pallas import fused_votes

    aligned = which == "aligned"
    if aligned:
        n, t, c, coefs, tol, batches = 100_000, 1024, 8, 8, 0.1, (1,)
    else:
        n, t, c, coefs, tol, batches = 102_400, 128, 2, 2, 0.01, (1, 16)
    f, k = 94, 1024
    if tiny:  # control-flow rehearsal on the CPU
        n, t, f, k = 300, t // 8, 20, 64
    db, mask = synth_db(n, t, c)
    for b in batches:
        ids = [(37 * i + 5) % n for i in range(b)]
        q, act, u2 = match_jax.prepare_query(
            excerpt_queries(db, ids, f), None, trunc_coef1=False)
        # the DB is an argument, never a captured constant
        kern = jax.jit(lambda d, q, a, u: fused_votes(
            d, q, a, u, tol, coefs=coefs, aligned=aligned))
        xla = jax.jit(lambda d, m, q, a, u: match_jax.match_votes(
            d, m, q, a, u, tol, coefs=coefs, aligned=aligned))

        def check(outs):
            k, x = np.asarray(outs["triton"]), np.asarray(outs["xla"])
            return {"equal": bool((k == x).all()),
                    "winners_ok": bool((k.argmax(1) == np.asarray(ids)).all()),
                    "max_votes": int(k.max())}

        race(f"{which} full {n}x{t}x{c} coefs={coefs} B={b}",
             {"xla": lambda: xla(db, mask, q, act, u2),
              "triton": lambda: kern(db, q, act, u2)}, reps, check)
        # the prefilter's rescore shape: K=1024 gathered rows per query
        rows = jnp.asarray(
            np.random.default_rng(3).integers(0, n, (b, k)), jnp.int32)
        rows = rows.at[:, 0].set(jnp.asarray(ids, jnp.int32))
        kern_r = jax.jit(lambda d, q, a, u, r: fused_votes(
            d, q, a, u, tol, coefs=coefs, aligned=aligned, rows=r))

        def xla_rows(d, m, q, a, u, r):
            def one(args):
                qb, ab, ub, rb = args
                return match_jax.match_votes(
                    d[rb], m[rb], qb[None], ab[None], ub[None], tol,
                    coefs=coefs, aligned=aligned)[0]
            return jax.lax.map(one, (q, a, u, r))

        xla_r = jax.jit(xla_rows)
        race(f"{which} rescore k={k} rows t={t} coefs={coefs} B={b}",
             {"xla": lambda: xla_r(db, mask, q, act, u2, rows),
              "triton": lambda: kern_r(db, q, act, u2, rows)}, reps,
             lambda o: {"equal": bool((np.asarray(o["triton"])
                                       == np.asarray(o["xla"])).all())})


def race_engine(reps: int, n_clips: int = 102_400, n_queries: int = 16,
                tiny: bool = False) -> None:
    """The engine calls that use the kernels: ``search_pcm_batch`` in the
    strict (bag) and accuracy (aligned) configurations — the one-dispatch
    program with its certified prefilter, and with the prefilter gates
    closed — kernel vs the XLA form forced in its place, in turns."""
    import tempfile

    import jax

    import chip_smoke
    import tiresias_tpu.api.engine as engine_mod
    import tiresias_tpu.ops.match_pallas as mp
    from tiresias_tpu.config import DspConfig

    if tiny:
        n_clips, n_queries = 600, 4
    serves = mp._serves

    def use(form):
        mp._serves = serves if form == "triton" else (lambda db, al: False)
        jax.clear_caches()
        engine_mod._fused_strict_fn.cache_clear()

    for label, dsp, kw in (("strict", DspConfig(), chip_smoke.STRICT),
                           ("aligned", DspConfig(n_coefs=8),
                            chip_smoke.ALIGNED)):
        eng = chip_smoke._engine(tempfile.mkdtemp(prefix="race_eng"), dsp)
        _, excerpts, _ = chip_smoke.build_corpus([eng], dsp, n_clips,
                                                 n_queries)
        for pf in (True, False):
            times = {"triton": [], "xla": []}
            answers = {}
            for form in ("triton", "xla", "xla", "triton"):
                use(form)
                for _ in range(2):  # compile, then warm
                    res = chip_smoke._search_pf(eng, excerpts, pf, **kw)[0]
                answers[form] = chip_smoke._keys(res)
                for _ in range(reps):
                    times[form].append(chip_smoke._search_pf(
                        eng, excerpts, pf, **kw)[1] * 1e3)
            use("triton")
            emit(race=f"engine {label} search_pcm_batch B={n_queries} "
                 f"{n_clips} clips prefilter={'on' if pf else 'off'}",
                 ms={k: float(np.median(v)) for k, v in times.items()},
                 check={"equal": answers["triton"] == answers["xla"]})
        eng.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="bag,aligned,engine")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--tiny", action="store_true",
                    help="matchers at toy sizes on any platform (rehearsal)")
    args = ap.parse_args(argv)
    import jax

    if args.tiny:
        for which in ("bag", "aligned"):
            race_matchers(1, which, tiny=True)
        race_engine(1, tiny=True)
        return 0
    if jax.devices()[0].platform != "gpu":
        print("kernel_race: no GPU", file=sys.stderr)
        return 2
    CARD.update(card())
    from tiresias_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    only = args.only.split(",")
    for which in ("bag", "aligned"):
        if which in only:
            race_matchers(args.reps, which)
    if "engine" in only:
        race_engine(args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
