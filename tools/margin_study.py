"""Margin-based acceptance study.

The fixed-tolerance design's noisy recall decays with corpus scale
(tol 0.1: 35/100 @10k -> 15/100 @1M) while the tol-0.3 rescue's
impostor confidences cross 0.5. Hypothesis: TRUE matches win by a wide
vote margin over the runner-up, impostors near-tie — so accepting on
margin = (v1 - v2) / v1 separates them where absolute confidence
cannot.

This study measures the margin distributions of true noisy matches vs
impostors at several tolerances against a synthetic speech-like corpus
(the bench_accuracy recipe), and prints recall/false-accept tables per
margin threshold.

Run: python tools/margin_study.py --tracks 10240
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tracks", type=int, default=10_240)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--impostors", type=int, default=50)
    ap.add_argument("--snr", type=float, default=20.0)
    args = ap.parse_args()

    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "bench.py")
    )
    bench = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("bench", bench)
    spec.loader.exec_module(bench)

    import tempfile

    import jax
    import jax.numpy as jnp

    from tiresias_tpu.api import Tiresias
    from tiresias_tpu.config import DspConfig, TiresiasConfig
    from tiresias_tpu.ops.mfcc_jax import fingerprint_padded_batch

    sr = 8000
    clip_s, query_s = 2.0, 1.5
    rng = np.random.default_rng(99)
    dsp = DspConfig(n_coefs=8)
    eng = Tiresias(
        TiresiasConfig(dsp=dsp, data_dir=tempfile.mkdtemp(prefix="tir_ms")),
        restore=False,
    )
    eng.create_context("c")
    n_tracks = args.tracks
    t0 = time.time()

    n_clip = int(clip_s * sr)
    n_clip -= n_clip % 256

    # device-synthesized corpus: bench_accuracy's synth_batch recipe
    def synth_batch(params, key):
        t = jnp.arange(n_clip, dtype=jnp.float32)[None, None, :] / sr
        f0, vibf, amp, modf, phase = params
        vib = 1.0 + 0.03 * jnp.sin(2 * jnp.pi * vibf[:, None, :] * t)
        h = jnp.arange(1, 9, dtype=jnp.float32)[None, :, None]
        mod = 1.0 + 0.5 * jnp.sin(2 * jnp.pi * modf * t + phase)
        out = (
            amp * mod * jnp.sin(2 * jnp.pi * f0[:, None, :] * h * vib * t)
        ).sum(axis=1)
        out += 0.02 * jax.random.normal(key, out.shape, jnp.float32)
        out *= 0.3 / jnp.maximum(1e-9, jnp.abs(out).max(axis=1, keepdims=True))
        i16 = jnp.clip(jnp.round(out * 32768.0), -32768, 32767).astype(jnp.int16)
        return i16, fingerprint_padded_batch(i16, sr, dsp)

    synth_batch_j = jax.jit(synth_batch)

    def draw_params(nb):
        return (
            jnp.asarray(rng.uniform(90, 220, (nb, 1)), jnp.float32),
            jnp.asarray(rng.uniform(3, 7, (nb, 1)), jnp.float32),
            jnp.asarray(
                rng.uniform(0.2, 1.0, (nb, 8, 1))
                / np.arange(1, 9)[None, :, None], jnp.float32,
            ),
            jnp.asarray(rng.uniform(0.5, 3.0, (nb, 8, 1)), jnp.float32),
            jnp.asarray(rng.uniform(0, 6.28, (nb, 8, 1)), jnp.float32),
        )

    bs = 512
    kept = {}
    targets = list(range(0, n_tracks, max(1, n_tracks // args.queries)))
    targets = targets[: args.queries]
    tset = set(targets)
    done = 0
    batch_no = 0
    while done < n_tracks:
        nb = min(bs, n_tracks - done)
        i16_d, fps_d = synth_batch_j(
            draw_params(nb), jax.random.PRNGKey(1000 + batch_no)
        )
        batch_no += 1
        fps = np.asarray(fps_d)
        rows = [j for j in range(nb) if done + j in tset]
        if rows:
            pcm_rows = np.asarray(i16_d[jnp.asarray(rows)])
            for j, pr in zip(rows, pcm_rows):
                kept[done + j] = pr.astype(np.float32) / 32768.0
        for j in range(nb):
            eng.store.add_audio(f"clip{done + j}", "c", fps[j],
                                f"ms{done + j:08d}")
        done += nb
    print(f"corpus ready: {done} tracks in {time.time() - t0:.0f}s",
          flush=True)

    qn = int(query_s * sr)
    qn -= qn % 256
    excerpts, truth = [], []
    for i in targets:
        off = int(rng.integers(0, int((clip_s - query_s) * sr)))
        off -= off % 256
        excerpts.append(kept[i][off : off + qn])
        truth.append(f"clip{i}")

    def add_noise(pcm, snr_db):
        sig = float((pcm**2).mean())
        noise = rng.standard_normal(len(pcm)).astype(np.float32)
        noise *= np.sqrt(sig / (10 ** (snr_db / 10)) / float((noise**2).mean()))
        return (pcm + noise).astype(np.float32)

    noisy = [add_noise(q, args.snr) for q in excerpts]
    impostors = list(bench._speechlike_batch(rng, args.impostors, query_s, sr))

    # full votes via the engine's staged host-ranked path. The margin
    # analysis needs the EXACT runner-up: the prefilter stays on for
    # speed but its certificate is taken at top=2 (a top-1-certified
    # candidate set can understate v2 and overstate margins — the same
    # rule the engine's _margin_search_batch uses)
    def votes_of(queries, **kw):
        votes, entries, n_frames = eng._compute_votes(
            "c", [np.asarray(p) for p in queries], sr,
            kw.get("coefs"), kw.get("tolerance"), -1, -1, False,
            kw.get("trunc_coef1"), kw.get("aligned"), prefilter=True,
            prefilter_top=2,
        )
        return votes, entries, n_frames

    def top2(v):
        i1 = int(np.argmax(v))
        v1 = int(v[i1])
        v = v.copy()
        v[i1] = -1
        v2 = int(v.max()) if v.shape[0] > 1 else 0
        return i1, v1, max(v2, 0)

    stats = {}  # tol -> dict of per-query arrays for true/impostor sets
    tols = (0.1, 0.2, 0.3, 0.35, 0.4, 0.45, 0.5)
    for tol in tols:
        kw = dict(coefs=8, tolerance=tol, trunc_coef1=False, aligned=True)
        vt, entries, nf = votes_of(noisy, **kw)
        vi, _, nfi = votes_of(impostors, **kw)
        names = [e.name for e in entries]
        rows_t = [top2(vt[i]) for i in range(len(noisy))]
        rows_i = [top2(vi[i]) for i in range(len(impostors))]

        def zscore(v, v1):
            mu, sd = float(v.mean()), float(v.std())
            return (v1 - mu) / sd if sd > 0 else 0.0

        stats[tol] = dict(
            names=names,
            wt=np.array([i1 for i1, _, _ in rows_t]),
            wi=np.array([i1 for i1, _, _ in rows_i]),
            m_t=np.array([(v1 - v2) / v1 if v1 > 0 else 0.0
                          for _, v1, v2 in rows_t]),
            m_i=np.array([(v1 - v2) / v1 if v1 > 0 else 0.0
                          for _, v1, v2 in rows_i]),
            conf_t=np.array([v1 / nf[i]
                             for i, (_, v1, _) in enumerate(rows_t)]),
            conf_i=np.array([v1 / nfi[i]
                             for i, (_, v1, _) in enumerate(rows_i)]),
            z_t=np.array([zscore(vt[i], v1)
                          for i, (_, v1, _) in enumerate(rows_t)]),
            z_i=np.array([zscore(vi[i], v1)
                          for i, (_, v1, _) in enumerate(rows_i)]),
            correct=np.array([
                names[i1] == want and v1 > 0
                for (i1, v1, _), want in zip(rows_t, truth)
            ]),
        )
        s = stats[tol]
        print(f"\n== tol {tol} ==  correct-top1 "
              f"{s['correct'].sum()}/{len(noisy)}")
        print(f"  z of winner: true-correct p10/p50 "
              f"{np.percentile(s['z_t'][s['correct']], [10, 50]).round(1) if s['correct'].any() else '-'}"
              f"  impostor p50/p90/max "
              f"{np.percentile(s['z_i'], [50, 90, 100]).round(1)}")
        print("  JOINT conf x margin acceptance (recall | FA):")
        for cthr in (0.0, 0.5, 0.6, 0.7, 0.75):
            row = []
            for mthr in (0.0, 0.05, 0.1, 0.2):
                rec = int((s["correct"] & (s["m_t"] >= mthr)
                           & (s["conf_t"] >= cthr)).sum())
                fa = int(((s["m_i"] >= mthr)
                          & (s["conf_i"] >= cthr)).sum())
                row.append(f"c>={cthr},m>={mthr}: {rec}|{fa}")
            print("   " + "  ".join(row))
        print("  Z-SCORE acceptance (recall | FA):")
        row = []
        for zthr in (10, 15, 20, 30, 50):
            rec = int((s["correct"] & (s["z_t"] >= zthr)).sum())
            fa = int((s["z_i"] >= zthr).sum())
            row.append(f"z>={zthr}: {rec}|{fa}")
        print("   " + "  ".join(row))

    # fine margin sweep at the promising tolerances
    for tol in (0.35, 0.4, 0.45):
        if tol not in stats:
            continue
        s = stats[tol]
        print(f"\n== fine margins, tol {tol} ==")
        for mthr in (0.06, 0.07, 0.08, 0.09, 0.1, 0.12, 0.15):
            rec = int((s["correct"] & (s["m_t"] >= mthr)).sum())
            fa = int((s["m_i"] >= mthr).sum())
            print(f"   m>={mthr}: recall {rec}/{len(noisy)} "
                  f"FA {fa}/{len(impostors)}")

    # combo: winner stable across (0.3, 0.4) AND margin at both
    if 0.3 in stats and 0.4 in stats:
        a, b = stats[0.3], stats[0.4]
        st_t = (a["wt"] == b["wt"]) & b["correct"]
        st_i = a["wi"] == b["wi"]
        print("\n== stable(0.3,0.4) & joint margins ==")
        print(f"  true stable&correct {st_t.sum()}  "
              f"impostor stable {st_i.sum()}/{len(impostors)}")
        for mthr in (0.0, 0.03, 0.05, 0.08, 0.1):
            rec = int((st_t & (a["m_t"] >= mthr)
                       & (b["m_t"] >= mthr)).sum())
            fa = int((st_i & (a["m_i"] >= mthr)
                      & (b["m_i"] >= mthr)).sum())
            print(f"   both m>={mthr}: recall {rec}/{len(noisy)} "
                  f"FA {fa}/{len(impostors)}")

    # cross-tolerance winner STABILITY: the true clip keeps winning as
    # the tolerance widens; impostors' near-tied winners wander
    for ta, tb in ((0.1, 0.3), (0.2, 0.3)):
        a, b = stats[ta], stats[tb]
        stable_t = a["wt"] == b["wt"]
        stable_i = a["wi"] == b["wi"]
        print(f"\n== stability {ta} vs {tb} ==")
        print(f"  true: stable {stable_t.sum()}/{len(noisy)} "
              f"(correct&stable {(b['correct'] & stable_t).sum()})")
        print(f"  impostor: stable {stable_i.sum()}/{len(impostors)}")
        for cthr in (0.0, 0.5, 0.6, 0.7):
            for mthr in (0.0, 0.05, 0.1):
                rec = int((b["correct"] & stable_t
                           & (b["m_t"] >= mthr)
                           & (b["conf_t"] >= cthr)).sum())
                fa = int((stable_i & (b["m_i"] >= mthr)
                          & (b["conf_i"] >= cthr)).sum())
                print(f"   stable & c>={cthr} & m>={mthr}: "
                      f"recall {rec}/{len(noisy)}  FA {fa}/{len(impostors)}")
    eng.close()


def weighted_study(tracks: int = 10_240) -> None:
    """Noise-weighted fingerprint space: divide every fingerprint
    (stored AND query) per coef by the measured 20 dB-SNR deviation
    profile, so one scalar tolerance means a per-coef tolerance matched
    to how much noise actually moves that coef (coefs 6-7 deviate ~6x
    more than coef 1 — a scalar tol over-trusts fragile coefs and
    under-uses stable ones)."""
    import tempfile

    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "bench.py")
    )
    bench = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("bench", bench)
    spec.loader.exec_module(bench)

    import jax
    import jax.numpy as jnp

    from tiresias_tpu.api import Tiresias
    from tiresias_tpu.config import DspConfig, TiresiasConfig
    from tiresias_tpu.ops.mfcc_jax import fingerprint_padded_batch

    sr = 8000
    clip_s, query_s = 2.0, 1.5
    rng = np.random.default_rng(99)
    dsp = DspConfig(n_coefs=8)
    # measured |delta| p90 per coef at 20 dB SNR (speechlike), mean-1
    w = np.array([0.182, 0.065, 0.131, 0.112, 0.110, 0.130, 0.274, 0.407],
                 np.float32)
    w /= w.mean()

    n_clip = int(clip_s * sr)
    n_clip -= n_clip % 256

    def synth_batch(params, key):
        t = jnp.arange(n_clip, dtype=jnp.float32)[None, None, :] / sr
        f0, vibf, amp, modf, phase = params
        vib = 1.0 + 0.03 * jnp.sin(2 * jnp.pi * vibf[:, None, :] * t)
        h = jnp.arange(1, 9, dtype=jnp.float32)[None, :, None]
        mod = 1.0 + 0.5 * jnp.sin(2 * jnp.pi * modf * t + phase)
        out = (amp * mod
               * jnp.sin(2 * jnp.pi * f0[:, None, :] * h * vib * t)).sum(axis=1)
        out += 0.02 * jax.random.normal(key, out.shape, jnp.float32)
        out *= 0.3 / jnp.maximum(1e-9, jnp.abs(out).max(axis=1, keepdims=True))
        i16 = jnp.clip(jnp.round(out * 32768.0), -32768, 32767).astype(jnp.int16)
        return i16, fingerprint_padded_batch(i16, sr, dsp)

    synth_batch_j = jax.jit(synth_batch)

    def draw_params(nb):
        return (
            jnp.asarray(rng.uniform(90, 220, (nb, 1)), jnp.float32),
            jnp.asarray(rng.uniform(3, 7, (nb, 1)), jnp.float32),
            jnp.asarray(rng.uniform(0.2, 1.0, (nb, 8, 1))
                        / np.arange(1, 9)[None, :, None], jnp.float32),
            jnp.asarray(rng.uniform(0.5, 3.0, (nb, 8, 1)), jnp.float32),
            jnp.asarray(rng.uniform(0, 6.28, (nb, 8, 1)), jnp.float32),
        )

    n_queries, n_imp = 100, 50
    targets = list(range(0, tracks, max(1, tracks // n_queries)))[:n_queries]
    tset = set(targets)
    bs = 512
    fp_rows, kept = [], {}
    done = batch_no = 0
    while done < tracks:
        nb = min(bs, tracks - done)
        i16_d, fps_d = synth_batch_j(
            draw_params(nb), jax.random.PRNGKey(1000 + batch_no))
        batch_no += 1
        fp_rows.append(np.asarray(fps_d))
        rows = [j for j in range(nb) if done + j in tset]
        if rows:
            pcm_rows = np.asarray(i16_d[jnp.asarray(rows)])
            for j, pr in zip(rows, pcm_rows):
                kept[done + j] = pr.astype(np.float32) / 32768.0
        done += nb
    fps = np.concatenate(fp_rows)  # [A, F, 8]
    print(f"corpus ready: {done} tracks", flush=True)

    qn = int(query_s * sr)
    qn -= qn % 256
    excerpts = []
    for i in targets:
        off = int(rng.integers(0, int((clip_s - query_s) * sr)))
        off -= off % 256
        excerpts.append(kept[i][off : off + qn])

    def add_noise(pcm, snr_db):
        sig = float((pcm**2).mean())
        noise = rng.standard_normal(len(pcm)).astype(np.float32)
        noise *= np.sqrt(sig / (10 ** (snr_db / 10)) / float((noise**2).mean()))
        return (pcm + noise).astype(np.float32)

    noisy = np.stack([add_noise(q, 20.0) for q in excerpts])
    impostors = bench._speechlike_batch(rng, n_imp, query_s, sr)

    qf_t = np.asarray(fingerprint_padded_batch(noisy, sr, dsp))
    qf_i = np.asarray(fingerprint_padded_batch(impostors, sr, dsp))

    def make_engine(db):
        # inject the (possibly scaled) fingerprints into a real store so
        # the votes ride the engine's fused Pallas dispatch (the XLA
        # matcher materializes B x F x A x T hit tensors — OOM at 100k)
        eng = Tiresias(
            TiresiasConfig(
                dsp=dsp, data_dir=tempfile.mkdtemp(prefix="tir_w")),
            restore=False,
        )
        eng.create_context("c")
        for i in range(db.shape[0]):
            eng.store.add_audio(f"clip{i}", "c", db[i], f"w{i:08d}")
        return eng

    n_q_frames = qn // dsp.hop_size  # real frames; bucket pad is masked

    def votes(eng, qf, tol):
        view = eng.store.search_views()[0]
        nf = np.full(qf.shape[0], n_q_frames, np.int32)
        v = eng._votes_for_view(
            view, jnp.asarray(qf), nf, 8, float(tol),
            -1, -1, False, True, True, False,
            prefilter_top=2,  # the margin analysis needs an exact v2
        )
        return np.asarray(v)[:, : view.n_audios]

    def top2(v):
        i1 = int(np.argmax(v)); v1 = int(v[i1])
        v = v.copy(); v[i1] = -1
        return i1, v1, max(int(v.max()), 0)

    for label, scale in (("scalar", np.ones(8, np.float32)), ("weighted", w)):
        db_s = (fps / scale).astype(np.float32)
        qt = (qf_t / scale).astype(np.float32)
        qi = (qf_i / scale).astype(np.float32)
        eng = make_engine(db_s)
        print(f"\n### {label} space, {tracks} distractors", flush=True)
        for tol in ((0.1, 0.2, 0.3) if label == "scalar"
                    else (0.1, 0.15, 0.2, 0.25, 0.3)):
            vt = votes(eng, qt, tol)
            vi = votes(eng, qi, tol)
            rt = [top2(vt[i]) for i in range(len(noisy))]
            ri = [top2(vi[i]) for i in range(len(impostors))]
            correct = np.array([i1 == t and v1 > 0
                                for (i1, v1, _), t in zip(rt, targets)])
            m_t = np.array([(v1 - v2) / v1 if v1 > 0 else 0 for _, v1, v2 in rt])
            m_i = np.array([(v1 - v2) / v1 if v1 > 0 else 0 for _, v1, v2 in ri])
            line = f"  tol {tol}: top1 {correct.sum()}/100 | margins:"
            for mthr in (0.0, 0.05, 0.1, 0.2, 0.3):
                rec = int((correct & (m_t >= mthr)).sum())
                fa = int((m_i >= mthr).sum())
                line += f"  m>={mthr}: {rec}|{fa}"
            print(line, flush=True)
        eng.close()


if __name__ == "__main__":
    if "--weighted" in sys.argv:
        tracks = 10_240
        if "--tracks" in sys.argv:
            tracks = int(sys.argv[sys.argv.index("--tracks") + 1])
        weighted_study(tracks)
    else:
        main()
