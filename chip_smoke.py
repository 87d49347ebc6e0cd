#!/usr/bin/env python3
"""Smoke test: the main path of tiresias at full size on the GPU.

    python chip_smoke.py          # one GPU: fingerprint, dialplan, strict,
                                  # aligned, server and kernel phases
    python chip_smoke.py --four   # four GPUs: the db-sharded engine against
                                  # a single-device engine, nothing else

Every phase runs in this one process, through the entry points a user
calls (``Tiresias``, ``RecognitionServer``, ``fingerprint_padded_batch``),
with random but seeded data generated on the device. Each line before the
last is one JSON object per phase: its name, the card's name and power
limit (read by ``nvidia-smi`` in a child process), its sizes, compile and
wall seconds — smoke timings, not benchmark numbers — and its parity
result. The last line is ``{"ok": true, "device": {...}}`` as JAX reports
the device. The script exits non-zero, without that line, when JAX finds
no GPU or any phase fails its check.

The phase functions take their sizes as arguments, so the tests drive them
on the CPU at toy sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))  # golden_corpus

import numpy as np  # noqa: E402

import bench  # noqa: E402  (the seeded on-device corpus builder)
from tiresias_tpu.api import Tiresias  # noqa: E402
from tiresias_tpu.config import DspConfig, TiresiasConfig  # noqa: E402

SR = 8000
GOLDENS = os.path.join(REPO, "tests", "goldens", "mfcc_goldens.npz")
# strict: the reference's own coefs=2 library configuration (no max1
# truncation); aligned: the accuracy mode (bench.py accuracy-scale uses
# min_margin 0.1)
STRICT = dict(coefs=2, tolerance=0.01, trunc_coef1=False)
ALIGNED = dict(coefs=8, tolerance=0.1, trunc_coef1=False, aligned=True,
               min_margin=0.1)


def card_info() -> dict:
    """The card's name and power limit, from ``nvidia-smi`` in a child
    process (it never touches JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    first = out[0] if out else "not available, not available"
    name, _, limit = first.partition(",")
    return {"card": name.strip(), "power_limit": limit.strip(),
            "nvidia_smi": out}


CARD: dict = {}


def emit(result: dict) -> None:
    print(json.dumps({**result, **{k: CARD[k] for k in
                                   ("card", "power_limit") if k in CARD},
                      "timing": "smoke"}), flush=True)


def _timed(fn):
    """(result, seconds) of ``fn()`` with every device output ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _keys(results) -> list:
    """The comparable content of a list of SearchResults."""
    return [(r.status, r.name, r.match_count, r.frame_count)
            for r in results]


def _engine(tmp: str, dsp: DspConfig, mesh=None) -> Tiresias:
    eng = Tiresias(TiresiasConfig(dsp=dsp, data_dir=tmp), restore=False,
                   mesh=mesh)
    eng.create_context("c")
    return eng


class _Tee:
    """Stands in for an engine in bench._build_synth_corpus so ONE seeded
    corpus lands in several stores at once."""

    def __init__(self, engines):
        self.store = self
        self._engines = engines

    def add_audio(self, *args, **kw):
        for eng in self._engines:
            eng.store.add_audio(*args, **kw)


def build_corpus(engines, dsp: DspConfig, n_clips: int, n_queries: int,
                 seed: int = 5):
    """Seeded speech-like 2-s clips synthesized and fingerprinted on the
    device (bench.py's builder) into every engine; returns the 1.5-s
    excerpt queries and the names of their true tracks."""
    rng = np.random.default_rng(seed)
    n, targets, kept = bench._build_synth_corpus(
        _Tee(engines), dsp, n_clips, n_queries, rng, SR, 2.0, tag="sm"
    )
    excerpts, truth = bench._corpus_queries(kept, targets, rng, SR, 2.0, 1.5)
    return n, excerpts, truth


def _search_pf(eng, pcms, prefilter: bool, **kw):
    """``search_pcm_batch`` with the engine's prefilter gates open or
    closed (closed as bench.py closes them), plus the number of
    certificate fallbacks it took."""
    from tiresias_tpu.utils.tracing import metrics

    def fallbacks():
        return int(metrics.snapshot()["counters"].get(
            "search.prefilter_fallbacks", 0))

    saved = eng._pf_allowed
    if not prefilter:
        eng._pf_allowed = lambda view, mode: False
    f0 = fallbacks()
    try:
        t0 = time.perf_counter()
        res = eng.search_pcm_batch("c", pcms, SR, **kw)
        dt = time.perf_counter() - t0
    finally:
        eng._pf_allowed = saved
    return res, dt, fallbacks() - f0


def _pf_equal(eng, pcms, **kw) -> dict:
    """Prefilter on vs off, result for result; the first call of each
    compiles, the second is timed warm."""
    on, first_s, _ = _search_pf(eng, pcms, True, **kw)
    on2, warm_s, fb = _search_pf(eng, pcms, True, **kw)
    off, off_first_s, _ = _search_pf(eng, pcms, False, **kw)
    off2, off_warm_s, _ = _search_pf(eng, pcms, False, **kw)
    same = _keys(on) == _keys(off) == _keys(on2) == _keys(off2)
    return {
        "results": on, "pf_equal": same,
        "found": sum(r.found for r in on),
        "pf_fallbacks": fb,
        "compile_s": round(first_s - warm_s, 3),
        "wall_s": round(warm_s, 4),
        "off_wall_s": round(off_warm_s, 4),
        "off_compile_s": round(off_first_s - off_warm_s, 3),
    }


# ---------------------------------------------------------------------- #
# phase 1: fingerprint
# ---------------------------------------------------------------------- #


def phase_fingerprint(batch: int = 256, samples: int = 480_000,
                      n_ref: int = 8, law_samples: int = 48_000) -> dict:
    """The fingerprint chain at the headline shape ``[batch, samples]``
    (float32, generated on the device), plus int16 and G.711 µ-law
    (``n_valid``) batches, against the frozen goldens and the float64
    oracle by the live-path rule (tests/test_goldens.py)."""
    import jax
    import jax.numpy as jnp

    from golden_corpus import MIN_COVERAGE, all_cases
    from tiresias_tpu.ops import reference_dsp as rdsp
    from tiresias_tpu.ops.mfcc_jax import (
        fingerprint_padded_batch,
        fingerprint_signal,
    )
    from tiresias_tpu.utils.g711 import SILENCE_BYTE, decode, encode

    dsp = DspConfig()
    hop = dsp.hop_size
    checks: dict = {}
    worst = {"worst_excess": -np.inf, "max_abs_diff": 0.0}

    def judge(label, rep, min_cov):
        ok = rep["worst_excess"] < rdsp.EXCESS_TOL and \
            rep["coverage"] >= min_cov
        checks[label] = {**{k: round(v, 6) for k, v in rep.items()},
                         "ok": bool(ok)}
        worst["worst_excess"] = max(worst["worst_excess"],
                                    rep["worst_excess"])
        worst["max_abs_diff"] = max(worst["max_abs_diff"],
                                    rep["max_abs_diff"])

    # (a) frozen golden corpus through the live path
    g = np.load(GOLDENS)
    for name, (make, rate) in sorted(all_cases().items()):
        ours = fingerprint_signal(make(), rate, dsp)
        bound = rdsp.fp_error_bound(g[f"{name}/mels"], g[f"{name}/coefs"],
                                    dsp)
        judge(f"golden/{name}", rdsp.parity_report(
            ours, g[f"{name}/fp"], bound), MIN_COVERAGE[name])

    # (b) the headline batch, generated on the device
    samples -= samples % hop
    pcm = jax.jit(lambda: 0.3 * jax.random.normal(
        jax.random.PRNGKey(0), (batch, samples), jnp.float32))()
    run = jax.jit(lambda p: fingerprint_padded_batch(p, SR, dsp))
    fp, first_s = _timed(lambda: run(pcm))
    _, wall_s = _timed(lambda: run(pcm))
    fp_host = np.asarray(fp)
    shape_ok = fp_host.shape == (batch, samples // hop, dsp.n_coefs)
    finite = bool(np.isfinite(fp_host).all())
    pcm_host = np.asarray(pcm[:n_ref])
    for i in range(min(n_ref, batch)):
        ref, bound = rdsp.oracle_stages(pcm_host[i], SR, dsp)
        judge(f"f32/{i}", rdsp.parity_report(fp_host[i], ref, bound), 0.95)

    # (c) int16 and (d) G.711 µ-law wire batches of the same clips
    n = min(law_samples, samples)
    n -= n % hop
    i16 = np.clip(np.round(pcm_host[:, :n] * 32768.0), -32768,
                  32767).astype(np.int16)
    fp16 = np.asarray(fingerprint_padded_batch(i16, SR, dsp))
    codes = np.stack([encode(r, "ulaw") for r in i16])
    n_valid = np.array([n - (n // 4) * i // max(1, len(i16)) - 77 * (i % 2)
                        for i in range(len(i16))], np.int32)
    for i, nv in enumerate(n_valid):
        codes[i, nv:] = SILENCE_BYTE["ulaw"]
    fpu = np.asarray(fingerprint_padded_batch(
        codes, SR, dsp, law="ulaw", n_valid=n_valid))
    for i in range(len(i16)):
        ref, bound = rdsp.oracle_stages(i16[i].astype(np.float64) / 32768.0,
                                        SR, dsp)
        judge(f"int16/{i}", rdsp.parity_report(fp16[i], ref, bound), 0.95)
        sig = decode(codes[i, : n_valid[i]], "ulaw").astype(np.float64)
        ref, bound = rdsp.oracle_stages(sig / 32768.0, SR, dsp)
        nf = rdsp.n_frames_for(int(n_valid[i]), hop)
        judge(f"ulaw/{i}", rdsp.parity_report(fpu[i, :nf], ref, bound), 0.95)

    ok = shape_ok and finite and all(c["ok"] for c in checks.values())
    return {
        "phase": "fingerprint", "ok": bool(ok),
        "sizes": {"batch": batch, "samples": samples,
                  "frames": samples // hop, "ref_clips": n_ref,
                  "law_samples": n},
        "compile_s": round(first_s - wall_s, 3), "wall_s": round(wall_s, 4),
        "shape_ok": shape_ok, "finite": finite,
        "worst_excess": round(worst["worst_excess"], 6),
        "excess_tol": rdsp.EXCESS_TOL,
        "max_abs_diff": round(worst["max_abs_diff"], 6),
        "failed_checks": [k for k, c in checks.items() if not c["ok"]],
        "n_checks": len(checks),
    }


# ---------------------------------------------------------------------- #
# phases 2-4: dialplan, strict, aligned
# ---------------------------------------------------------------------- #


def _oracle_check(eng, results, pcms, n_oracle: int, sub_rows: int,
                  truth: list, **kw) -> list:
    """The SQL oracle (ops/match_ref.py) over a sub-store of
    ``sub_rows`` rows holding the engine's winner and the true track,
    reading the query fingerprints the device produced. The engine's
    winner has the most votes over the whole store, so it must win the
    sub-store with the same count (lowest insertion index on ties)."""
    from tiresias_tpu.ops.match_ref import search_reference
    from tiresias_tpu.ops.mfcc_jax import fingerprint_signals

    entries = eng.get_audios("c")
    index = {e.name: i for i, e in enumerate(entries)}
    dsp = eng.config.dsp
    qfp, nf = fingerprint_signals(pcms[:n_oracle], SR, dsp)
    out = []
    for i, r in enumerate(results[:n_oracle]):
        t = index[truth[i]]
        lo = max(0, min(t - sub_rows // 2, len(entries) - sub_rows))
        rows = set(range(lo, min(len(entries), lo + sub_rows)))
        if r.found:
            rows = set(sorted(rows - {t})[: sub_rows - 2]) | {t}
            rows.add(index[r.name])
        rows = sorted(rows)
        db = [eng.store.get_fingerprint(entries[j].uuid) for j in rows]
        ref = search_reference(db, qfp[i, : nf[i]], coefs=kw["coefs"],
                               tolerance=kw["tolerance"],
                               trunc_coef1=kw["trunc_coef1"])
        want = (entries[rows[ref.best_index]].name
                if ref.best_index is not None else None)
        got = r.name if r.found else None
        out.append({"engine": [got, r.match_count],
                    "oracle": [want, ref.match_count],
                    "equal": got == want and r.match_count == ref.match_count})
    return out


def phase_dialplan(n_clips: int = 102_400, n_queries: int = 16,
                   n_oracle: int = 4, sub_rows: int = 1024,
                   keep: dict | None = None) -> dict:
    """The default configuration — coefs=1, truncated max1, the lattice
    matcher with its certified uint8 prefilter — on a store of
    ``n_clips`` 2-s clips: prefilter on == off, and the SQL oracle."""
    from tiresias_tpu.config import DEF_SEARCH_TOLERANCE

    dsp = DspConfig()
    eng = _engine(tempfile.mkdtemp(prefix="smoke_dp"), dsp)
    t0 = time.perf_counter()
    n, excerpts, truth = build_corpus([eng], dsp, n_clips, n_queries)
    build_s = time.perf_counter() - t0
    res = _pf_equal(eng, excerpts)
    kw = dict(coefs=1, tolerance=DEF_SEARCH_TOLERANCE, trunc_coef1=True)
    oracle = _oracle_check(eng, res.pop("results"), excerpts, n_oracle,
                           sub_rows, truth, **kw)
    view = eng.store.search_views()[0]
    if keep is not None:
        keep.update(engine=eng, excerpts=excerpts, truth=truth)
    else:
        eng.close()
    ok = res["pf_equal"] and all(o["equal"] for o in oracle)
    return {
        "phase": "dialplan", "ok": bool(ok),
        "sizes": {"clips": n, "tier_frames": int(view.tier_frames),
                  "queries": len(excerpts), "oracle_rows": sub_rows},
        "build_s": round(build_s, 2), **res, "oracle": oracle,
    }


def phase_strict(eng, excerpts, truth, n_oracle: int = 4,
                 sub_rows: int = 1024) -> dict:
    """The strict configuration (coefs=2, no truncation, tolerance 0.01)
    on the dialplan store, through the one-dispatch program
    (``_fused_strict_fn``): prefilter on == off, certificates counted."""
    import tiresias_tpu.api.engine as engine_mod

    certs = {"certified": 0, "refused": 0}
    saved_note = eng._pf_note

    def note(view, mode, certified):
        certs["certified" if certified else "refused"] += 1
        saved_note(view, mode, certified)

    fused = {"n": 0}
    saved_fused = eng._fused_strict_batch

    def spy(*a, **k):
        out = saved_fused(*a, **k)
        fused["n"] += out is not None
        return out

    eng._pf_note, eng._fused_strict_batch = note, spy
    try:
        res = _pf_equal(eng, excerpts, **STRICT)
    finally:
        eng._pf_note, eng._fused_strict_batch = saved_note, saved_fused
    oracle = _oracle_check(eng, res.pop("results"), excerpts, n_oracle,
                           sub_rows, truth, **STRICT)
    ok = res["pf_equal"] and fused["n"] == 4 and all(
        o["equal"] for o in oracle)
    return {
        "phase": "strict", "ok": bool(ok),
        "sizes": {"clips": len(eng.get_audios("c")),
                  "queries": len(excerpts)},
        "config": STRICT, "fused_program_calls": fused["n"],
        "certificates": certs, **res, "oracle": oracle,
        "program": engine_mod._fused_strict_fn.__name__,
    }


def _aligned_matrix(n: int, t: int, c: int, n_q: int = 8, f: int = 93,
                    interpret: bool = False) -> dict:
    """The accuracy mode on a device-generated ``[n, t, c]`` matrix
    (bench.py aligned-scale generator): certified prefilter
    (``aligned_prefiltered_votes``) vs the full aligned scan."""
    import jax
    import jax.numpy as jnp

    from tiresias_tpu.ops import match_jax
    from tiresias_tpu.ops.match_lattice import build_bound_maps
    from tiresias_tpu.ops.match_pallas import (
        aligned_prefiltered_votes,
        fused_votes,
    )
    from tools.kernel_race import excerpt_queries, synth_db

    db, mask = synth_db(n, t, c)
    qf = min(f, t // 2 - 8)
    ids = [(977 * i + 5) % n for i in range(n_q)]
    q, act, u2 = match_jax.prepare_query(
        excerpt_queries(db, ids, qf), None, trunc_coef1=False)
    specs, maps = build_bound_maps(db, mask)
    tol = jnp.float32(ALIGNED["tolerance"])
    k = min(1024, n // 2)
    # the matrix and maps are arguments, never captured constants
    full = jax.jit(lambda d, q, a, u: match_jax.top1(fused_votes(
        d, q, a, u, tol, coefs=c, aligned=True, interpret=interpret)))

    @jax.jit
    def pre(d, m, q, a, u):
        v, cert = aligned_prefiltered_votes(
            d, m, q, a, u, tol, specs=specs, coefs=c, k=k,
            interpret=interpret)
        return (*match_jax.top1(v), cert)

    (fb, fc), full_first = _timed(lambda: full(db, q, act, u2))
    _, full_s = _timed(lambda: full(db, q, act, u2))
    (pb, pc, cert), pre_first = _timed(lambda: pre(db, maps, q, act, u2))
    _, pre_s = _timed(lambda: pre(db, maps, q, act, u2))
    cert = np.asarray(cert)
    same = (np.asarray(pb) == np.asarray(fb)) & (np.asarray(pc)
                                                 == np.asarray(fc))
    return {
        "sizes": [n, t, c], "queries": n_q, "query_frames": qf, "k": k,
        "certified": int(cert.sum()),
        "equal_where_certified": bool(same[cert].all()),
        "winners_true": int((np.asarray(fb) == np.asarray(ids)).sum()),
        "full_compile_s": round(full_first - full_s, 3),
        "full_wall_s": round(full_s, 4),
        "pf_compile_s": round(pre_first - pre_s, 3),
        "pf_wall_s": round(pre_s, 4),
        "ok": bool(same[cert].all() and cert.any()),
    }


def phase_aligned(n_clips: int = 102_400, n_queries: int = 16,
                  matrix: tuple = (100_000, 1024, 8),
                  interpret: bool = False) -> dict:
    """The accuracy mode (8 coefs, aligned, tolerance 0.1, min_margin
    0.1): an engine store of ``n_clips`` clips, prefilter on == off; and
    the ``matrix``-sized device matrix, prefiltered == full scan."""
    dsp = DspConfig(n_coefs=8)
    eng = _engine(tempfile.mkdtemp(prefix="smoke_al"), dsp)
    t0 = time.perf_counter()
    n, excerpts, truth = build_corpus([eng], dsp, n_clips, n_queries)
    build_s = time.perf_counter() - t0
    res = _pf_equal(eng, excerpts, **ALIGNED)
    res.pop("results")
    eng.close()
    mat = _aligned_matrix(*matrix, interpret=interpret)
    return {
        "phase": "aligned", "ok": bool(res["pf_equal"] and mat["ok"]),
        "sizes": {"clips": n, "queries": len(excerpts)},
        "config": ALIGNED, "build_s": round(build_s, 2), **res,
        "matrix": mat,
    }


# ---------------------------------------------------------------------- #
# phase 5: server
# ---------------------------------------------------------------------- #


def phase_server(eng, excerpts, n_clients: int = 16) -> dict:
    """A RecognitionServer on port 0 in this process; ``n_clients``
    threads that never touch JAX send 3-s int16 and µ-law windows over
    TCP. Every reply must equal the engine's own answer for that PCM."""
    import asyncio
    import base64
    import socket
    import threading

    from tiresias_tpu.serve.server import RecognitionServer, \
        warmup_batch_sizes
    from tiresias_tpu.utils.audio import float_to_i16
    from tiresias_tpu.utils.g711 import encode

    t0 = time.perf_counter()
    th = eng.warmup_async(samplerate=SR,
                          batch_sizes=warmup_batch_sizes(n_clients),
                          laws=("ulaw",))
    ready_s = time.perf_counter() - t0
    th.join()
    warm_s = time.perf_counter() - t0

    win = 3 * SR
    windows = []
    for i in range(n_clients):
        a, b = excerpts[i % len(excerpts)], excerpts[(i + 1) % len(excerpts)]
        pcm = np.concatenate([a, b, a])[:win]
        i16 = float_to_i16(pcm)
        law = "ulaw" if i % 2 else None
        windows.append((i16 if law is None else encode(i16, law), law))

    holder: dict = {}
    started = threading.Event()

    def runner():
        async def amain():
            srv = RecognitionServer(eng, port=0, samplerate=SR,
                                    max_channels=max(16, n_clients))
            await srv.start()
            holder.update(server=srv, loop=asyncio.get_running_loop())
            started.set()
            try:
                await srv.serve_forever()
            except asyncio.CancelledError:
                pass

        asyncio.run(amain())

    threading.Thread(target=runner, daemon=True).start()
    if not started.wait(120):
        raise RuntimeError("server did not start")
    port = holder["server"].port
    replies: list = [None] * n_clients

    def client(i):
        data, law = windows[i]
        with socket.create_connection(("127.0.0.1", port), timeout=300) as s:
            f = s.makefile("rw", encoding="utf-8", newline="\n")
            msg = {"op": "open", "channel": f"s{i}", "context": "c",
                   "duration_ms": 3000}
            if law:
                msg["format"] = law
            f.write(json.dumps(msg) + "\n")
            f.flush()
            if not json.loads(f.readline()).get("opened"):
                raise RuntimeError(f"channel s{i} not opened")
            raw = data.astype("<i2").tobytes() if law is None \
                else data.tobytes()
            f.write(json.dumps({"op": "pcm", "channel": f"s{i}",
                                "pcm": base64.b64encode(raw).decode()})
                    + "\n")
            f.flush()
            replies[i] = json.loads(f.readline())

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    serve_s = time.perf_counter() - t0
    asyncio.run_coroutine_threadsafe(
        holder["server"].stop(), holder["loop"]).result(timeout=60)

    fields = ("TIRSTATUS", "TIRFILENAME", "TIRMATCHCOUNT", "TIRFRAMECOUNT")
    mismatches = []
    for i, (data, law) in enumerate(windows):
        pcm = data if law else data.astype(np.float32) / 32768.0
        want = eng.search_pcm_batch("c", [pcm], SR, wire_law=law)[0]
        want = want.to_channel_vars()
        got = (replies[i] or {}).get("result") or {}
        if any(got.get(k) != want.get(k) for k in fields):
            mismatches.append({"window": i, "law": law, "server": got,
                               "engine": want})
    return {
        "phase": "server", "ok": not mismatches and all(replies),
        "sizes": {"clients": n_clients, "window_s": 3,
                  "clips": len(eng.get_audios("c"))},
        "ready_s": round(ready_s, 3), "full_warm_s": round(warm_s, 3),
        "serve_wall_s": round(serve_s, 3),
        "found": sum((r or {}).get("result", {}).get("TIRSTATUS")
                     == "FOUND" for r in replies),
        "mismatches": mismatches,
    }


# ---------------------------------------------------------------------- #
# phase 6: kernels
# ---------------------------------------------------------------------- #


def phase_kernels(bag_db=None, n_q: int = 16,
                  aligned_shape: tuple = (100_000, 1024, 8),
                  interpret: bool = False) -> dict:
    """Each hand-written kernel at its phase's real widths against the
    plain XLA form (``match_jax.match_votes``): integer votes equal.
    ``compiled.memory_analysis()`` is reported once per kernel."""
    import jax

    from tiresias_tpu.ops import match_jax
    from tiresias_tpu.ops.match_pallas import fused_votes
    from tools.kernel_race import excerpt_queries, synth_db

    out = {}
    for name, aligned, coefs, tol in (("bag", False, 2, 0.01),
                                      ("aligned", True, 8, 0.1)):
        if aligned or bag_db is None:
            shape = aligned_shape if aligned else (102_400, 128, 2)
            db, mask = synth_db(*shape)
        else:
            db = bag_db
            mask = db[..., 0] > -1e5
        a, t, c = db.shape
        b = 1 if aligned else n_q
        ids = [(389 * i + 7) % a for i in range(b)]
        f = min(93, t // 2 - 8)
        q, act, u2 = match_jax.prepare_query(
            excerpt_queries(db, ids, f), None, trunc_coef1=False)
        # the DB is an argument, never a captured constant
        kern = jax.jit(lambda d, q, a_, u: fused_votes(
            d, q, a_, u, tol, coefs=coefs, aligned=aligned,
            interpret=interpret))
        xla = jax.jit(lambda d, m, q, a_, u: match_jax.match_votes(
            d, m, q, a_, u, tol, coefs=coefs, aligned=aligned))
        mem = kern.lower(db, q, act, u2).compile().memory_analysis()
        vk, k_first = _timed(lambda: kern(db, q, act, u2))
        _, k_s = _timed(lambda: kern(db, q, act, u2))
        vx, x_first = _timed(lambda: xla(db, mask, q, act, u2))
        _, x_s = _timed(lambda: xla(db, mask, q, act, u2))
        vk, vx = np.asarray(vk), np.asarray(vx)
        out[name] = {
            "sizes": [a, t, c], "queries": b, "query_frames": f,
            "coefs": coefs, "equal": bool((vk == vx).all()),
            "max_votes": int(vk.max()),
            "kernel_compile_s": round(k_first - k_s, 3),
            "kernel_wall_s": round(k_s, 4),
            "xla_compile_s": round(x_first - x_s, 3),
            "xla_wall_s": round(x_s, 4),
            "memory_analysis": str(mem),
        }
        del db, mask
    return {"phase": "kernels",
            "ok": all(v["equal"] for v in out.values()), **out}


# ---------------------------------------------------------------------- #
# --four: the db-sharded engine
# ---------------------------------------------------------------------- #


def phase_four(n_clips: int = 102_400, n_queries: int = 16,
               n_devices: int = 4) -> dict:
    """An engine with ``mesh="auto"`` (every device on the ``db`` axis)
    against a single-device engine in the same process, on the dialplan,
    strict and aligned stores: answers equal, result for result."""
    import jax

    if len(jax.local_devices()) < n_devices:
        raise RuntimeError(f"--four needs {n_devices} devices, "
                           f"found {len(jax.local_devices())}")
    out: dict = {"phase": "four", "mesh": None, "configs": {}}
    for dsp, configs in ((DspConfig(), (("dialplan", {}),
                                        ("strict", STRICT))),
                         (DspConfig(n_coefs=8), (("aligned", ALIGNED),))):
        sharded = _engine(tempfile.mkdtemp(prefix="smoke4"), dsp,
                          mesh="auto")
        single = _engine(tempfile.mkdtemp(prefix="smoke1"), dsp)
        out["mesh"] = {k: int(v) for k, v in sharded.mesh.shape.items()}
        t0 = time.perf_counter()
        n, excerpts, _ = build_corpus([sharded, single], dsp, n_clips,
                                      n_queries)
        build_s = time.perf_counter() - t0
        for label, kw in configs:
            timing = {}
            for name, eng in (("sharded", sharded), ("single", single)):
                res, first = _timed(lambda: eng.search_pcm_batch(
                    "c", excerpts, SR, **kw))
                res, warm = _timed(lambda: eng.search_pcm_batch(
                    "c", excerpts, SR, **kw))
                timing[name] = (res, first, warm)
            rs, r1 = timing["sharded"][0], timing["single"][0]
            out["configs"][label] = {
                "equal": _keys(rs) == _keys(r1),
                "found": sum(r.found for r in rs), "clips": n,
                "queries": len(excerpts), "build_s": round(build_s, 2),
                **{f"{k}_wall_s": round(v[2], 4)
                   for k, v in timing.items()},
                **{f"{k}_compile_s": round(v[1] - v[2], 3)
                   for k, v in timing.items()},
            }
        sharded.close()
        single.close()
    out["ok"] = all(c["equal"] for c in out["configs"].values())
    return out


# ---------------------------------------------------------------------- #


def require_gpu() -> dict:
    """The device as JAX reports it; exits 2 without printing a result
    when it is no GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        sys.exit(2)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def _run(result: dict) -> None:
    emit(result)
    if not result["ok"]:
        print(f"chip_smoke: phase {result['phase']} failed",
              file=sys.stderr)
        sys.exit(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded path")
    args = ap.parse_args(argv)
    device = require_gpu()
    CARD.update(card_info())
    print(json.dumps({"phase": "card", "nvidia_smi": CARD["nvidia_smi"]}),
          flush=True)
    from tiresias_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    if args.four:
        _run(phase_four())
    else:
        _run(phase_fingerprint())
        state: dict = {}
        _run(phase_dialplan(keep=state))
        _run(phase_strict(state["engine"], state["excerpts"],
                          state["truth"]))
        _run(phase_server(state["engine"], state["excerpts"]))
        view = state["engine"].store.search_views()[0]
        bag_db = view.db
        _run(phase_aligned())
        _run(phase_kernels(bag_db=bag_db))
        state["engine"].close()
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
