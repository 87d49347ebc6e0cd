"""Golden tests: JAX fingerprint chain vs the NumPy oracle.

The float32 compute path cannot match the float64 oracle uniformly: the
chain ends in 10·log10|DCT(log10(mel))|, and wherever a mel filter's energy
sits near the float32 FFT leakage noise floor (pure tones in far filters),
*any* float32 implementation — aubio included — produces implementation
noise there. So the comparison uses a first-order error-propagation bound
computed from the golden mel energies:

    err(L_j)   = α·E_max / (E_j·ln10)           (log10 mel energy)
    err(c_k)   = Σ_j |dct_kj|·err(L_j)          (DCT coefficient)
    err(fp_k)  = (10/ln10)·err(c_k)/|c_k|       (stored value)

with α the float32 FFT/sum noise scale. Entries whose predicted bound
exceeds a cap are skipped (they are noise in every float32 implementation);
everything else must agree within 5e-3 + bound.
"""

import numpy as np
import pytest

from tiresias_tpu.config import DspConfig
from tiresias_tpu.ops import mfcc_jax, reference_dsp as rdsp
from tiresias_tpu.ops.dct import dct_matrix
from tiresias_tpu.utils.audio import synth_chirp, synth_noise, synth_tone

SR = 8000
ALPHA = 2e-5  # float32 noise scale of the magnitude-spectrum path
BOUND_CAP = 0.2  # skip entries whose predicted float32 noise exceeds this
LN10 = np.log(10.0)


def _golden(pcm, dsp=None):
    return rdsp.fingerprint_signal(np.asarray(pcm, dtype=np.float64), SR, dsp)


def fp_error_bound(pcm, dsp=None):
    """Per-(frame, coef) predicted float32 noise of the stored value."""
    dsp = dsp or DspConfig()
    frames = rdsp.frame_signal(np.asarray(pcm, dtype=np.float64), dsp)
    mels = rdsp.mel_energies(rdsp.magnitude_spectrum(frames, dsp), dsp, SR)
    coefs = rdsp.mfcc(rdsp.log_mel(mels), dsp)
    e_max = mels.max(axis=1, keepdims=True)
    # filters with exactly zero weight rows give exact zeros in both paths
    rel = np.where(mels > 0, ALPHA * e_max / np.maximum(mels, 1e-300), 0.0)
    err_l = rel / LN10
    dct = np.abs(dct_matrix(dsp.n_filters, dsp.n_coefs))  # [C, J]
    err_c = err_l @ dct.T
    return (10.0 / LN10) * err_c / np.maximum(np.abs(coefs), 1e-12)


def assert_fp_close(ours, golden, bound, atol=5e-3, min_coverage=0.02):
    """min_coverage is signal-dependent: broadband signals are trustworthy
    almost everywhere; pure tones only near informative filters."""
    assert ours.shape == golden.shape
    use = bound < BOUND_CAP
    assert use.mean() >= min_coverage, "error bound excludes too much — vacuous"
    diff = np.abs(ours - golden) - bound
    worst = diff[use].max()
    assert worst < atol, f"max excess diff {worst}"


CASES = {
    "tone_440": lambda: synth_tone(440.0, 1.7, SR),
    "tone_1000": lambda: synth_tone(1000.0, 0.5, SR),
    "chirp": lambda: synth_chirp(200.0, 3600.0, 2.0, SR),
    "noise": lambda: synth_noise(1.3, SR, seed=7),
    "speechlike": lambda: (
        synth_tone(300.0, 1.0, SR) + 0.3 * synth_tone(2200.0, 1.0, SR)
        + synth_noise(1.0, SR, amplitude=0.05, seed=3)
    ),
    "short_partial_hop": lambda: synth_tone(600.0, 0.0801, SR),
}


# broadband signals must be float32-trustworthy almost everywhere; pure
# tones only at a minority of entries (far filters sit at the FFT noise
# floor — aubio's own float32 output is noise there too).
MIN_COVERAGE = {
    "noise": 0.95,
    "speechlike": 0.95,
    "tone_440": 0.02,
    "tone_1000": 0.05,
    "chirp": 0.02,
    "short_partial_hop": 0.02,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fingerprint_matches_golden(name):
    pcm = CASES[name]()
    ours = np.asarray(mfcc_jax.fingerprint_signal(pcm, SR))
    golden = _golden(pcm)
    assert_fp_close(ours, golden, fp_error_bound(pcm), min_coverage=MIN_COVERAGE[name])


def test_framing_matches_golden():
    import jax.numpy as jnp

    dsp = DspConfig()
    pcm = synth_noise(0.33, SR, seed=1)
    nf = rdsp.n_frames_for(len(pcm), dsp.hop_size)
    padded = np.zeros(nf * dsp.hop_size, dtype=np.float32)
    padded[: len(pcm)] = pcm
    ours = np.asarray(mfcc_jax.frames_from_pcm(jnp.asarray(padded), dsp.hop_size, dsp.buf_size))
    golden = rdsp.frame_signal(pcm, dsp)
    np.testing.assert_allclose(ours, golden, atol=1e-7)


def test_batch_consistency_with_single():
    pcms = [synth_tone(500.0, 1.0, SR), synth_noise(2.0, SR, seed=2), synth_tone(900.0, 0.4, SR)]
    fp_b, n_frames = mfcc_jax.fingerprint_signals(pcms, SR)
    for i, pcm in enumerate(pcms):
        single = mfcc_jax.fingerprint_signal(pcm, SR)
        assert n_frames[i] == single.shape[0]
        np.testing.assert_allclose(fp_b[i, : n_frames[i]], single, atol=1e-5)
        # padding region must be PAD_VALUE
        assert (fp_b[i, n_frames[i] :] == mfcc_jax.PAD_VALUE).all()


def test_bucketing():
    assert mfcc_jax.bucket_frames(1) == 128
    assert mfcc_jax.bucket_frames(128) == 128
    assert mfcc_jax.bucket_frames(129) == 256
    assert mfcc_jax.bucket_frames(947) == 1024


def test_nondefault_dsp_profile():
    """Extension profiles (different hop/filters/coefs) stay golden-true."""
    dsp = DspConfig(hop_size=512, buf_size=1024, n_filters=26, n_coefs=13)
    pcm = synth_chirp(100.0, 3000.0, 1.0, SR)
    ours = np.asarray(mfcc_jax.fingerprint_signal(pcm, SR, dsp))
    golden = rdsp.fingerprint_signal(np.asarray(pcm, dtype=np.float64), SR, dsp)
    assert_fp_close(ours, golden, fp_error_bound(pcm, dsp))


def test_device_constant_cache_safe_under_tracing():
    """Populating the device-constant caches INSIDE a jit trace must not
    leak tracers into later eager calls (the first engine search on a
    fresh process traces the whole fingerprint chain)."""
    import jax
    import jax.numpy as jnp

    from tiresias_tpu.config import DspConfig
    from tiresias_tpu.ops import mfcc_jax
    from tiresias_tpu.ops.mfcc_jax import fingerprint_padded_batch

    dsp = DspConfig(n_filters=20, n_coefs=2)  # unique key -> fresh cache
    assert (dsp, 8000) not in mfcc_jax._device_consts_cache
    pcm = np.zeros((1, 2048), np.float32)

    @jax.jit
    def traced(p):
        return fingerprint_padded_batch(p, 8000, dsp)

    traced(pcm)  # populates nothing (tracers must not be cached)
    assert all(
        not isinstance(o, jax.core.Tracer)
        for o in mfcc_jax._device_consts_cache.get((dsp, 8000), ())
    )
    out = fingerprint_padded_batch(pcm, 8000, dsp)  # eager: must not raise
    assert np.asarray(out).shape == (1, 8, 2)


def _edge_case(name):
    """(pcm batch as the padded entry point takes it, per-row true sample
    counts, DspConfig, wire law) for the padded-batch edge cases."""
    rng = np.random.default_rng(abs(hash(name)) % 2**32)
    dsp = DspConfig()
    hop = dsp.hop_size
    if name == "framing_boundary":  # length an exact multiple of the hop
        sig = [0.3 * rng.standard_normal(32 * hop)]
    elif name == "partial_hop":  # final hop zero-padded (ceil(n/hop) frames)
        sig = [0.3 * rng.standard_normal(32 * hop + 77)]
    elif name == "partial_tile":  # ragged batch, rows padded to one bucket
        sig = [0.3 * rng.standard_normal(n) for n in (5000, 2 * 4096, 300)]
    elif name == "long_signal":  # many frames, zero halo before t=0
        sig = [0.3 * rng.standard_normal(293 * hop)]
    elif name == "silence_floor":  # all-zero input → floor values
        sig = [np.zeros(8 * hop)]
    elif name == "non_2x_overlap":  # window of four hops
        dsp = DspConfig(hop_size=128, buf_size=512)
        sig = [0.3 * rng.standard_normal(60 * 128)]
    elif name in ("g711_ulaw_n_valid", "g711_alaw_n_valid"):
        sig = [0.3 * rng.standard_normal(n) for n in (4000, 6000 - 13)]
    else:
        raise KeyError(name)
    return [np.asarray(s, np.float32) for s in sig], dsp


@pytest.mark.parametrize("name", [
    "framing_boundary", "partial_hop", "partial_tile", "long_signal",
    "silence_floor", "non_2x_overlap", "g711_ulaw_n_valid",
    "g711_alaw_n_valid",
])
def test_padded_batch_edge_cases_match_oracle(name):
    """The device chain's padded-batch entry point (the path every search
    and ingest batch takes) against the float64 oracle, by the golden
    live-path rule: framing boundaries, partial hops and ragged rows, the
    silence floor, a non-2x window overlap, and G.711 batches whose
    decoded padding is masked by ``n_valid``."""
    from tiresias_tpu.ops.mfcc_jax import fingerprint_padded_batch, pad_frames_bucket
    from tiresias_tpu.utils.audio import float_to_i16
    from tiresias_tpu.utils.g711 import decode, encode

    sigs, dsp = _edge_case(name)
    law = None
    if name.startswith("g711"):
        law = name.split("_")[1]
        sigs = [encode(float_to_i16(s), law) for s in sigs]
        refs = [decode(s, law).astype(np.float64) / 32768.0 for s in sigs]
    else:
        refs = [s.astype(np.float64) for s in sigs]
    padded, n_frames = pad_frames_bucket(sigs, dsp.hop_size, law=law)
    n_valid = (np.array([len(s) for s in sigs], np.int32)
               if law is not None else None)
    got = np.asarray(fingerprint_padded_batch(padded, SR, dsp, law=law,
                                              n_valid=n_valid))
    for i, ref_pcm in enumerate(refs):
        golden, bound = rdsp.oracle_stages(ref_pcm, SR, dsp)
        ours = got[i, : n_frames[i]]
        if name == "silence_floor":
            # constant log-mel rows: coef 0 is exact, higher coefs are
            # float rounding of zero — float32 gives exactly 0, i.e. the
            # SAFE_LOG10 floor, float64 a 1e-14 residue
            floor = 10.0 * np.log10(rdsp.VERY_SMALL_NUMBER)
            np.testing.assert_allclose(ours[:, 0], golden[:, 0], atol=1e-4)
            assert np.isfinite(ours).all() and (ours >= floor - 1e-3).all()
            continue
        rep = rdsp.parity_report(ours, golden, bound)
        assert rep["coverage"] >= 0.9, rep
        assert rep["worst_excess"] < rdsp.EXCESS_TOL, rep
