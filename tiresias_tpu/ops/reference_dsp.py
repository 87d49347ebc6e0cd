"""NumPy golden model of the reference fingerprint DSP chain.

This is the numerical oracle for the whole framework: a from-scratch,
float64 NumPy re-derivation of the aubio pipeline the reference drives in
``create_audio_fingerprints`` (/root/reference/src/fp_handler.c:577-671):

    source(hop=256) → pvoc(win=512, hop=256) → |rFFT| → mel(40, Slaney)
        → log10 → DCT-II(→ n_coefs) → 10*log10(|coef|)

Chain details replicated (and documented in PARITY.md):
  * **pvoc framing**: aubio's phase vocoder keeps a sliding buffer initialised
    to zeros; after the f-th hop it holds samples
    ``[(f+1)*hop - win, (f+1)*hop)`` with implicit left zero padding.
  * **frame count**: the reference loops until ``aubio_source_do`` reads 0
    samples and zero-pads a short final hop, so ``n_frames = ceil(n/hop)``
    (/root/reference/src/fp_handler.c:632-636).
  * **window**: 'hanningz' (periodic Hann). The pvoc's zero-phase circular
    shift (`fvec_shift`) is omitted: it changes FFT phase only and the MFCC
    consumes magnitudes.
  * **FFT**: unnormalised forward rFFT, 257 magnitude bins.
  * **mel**: Slaney 40-triangle bank applied to *magnitudes* (power=1).
  * **log**: aubio ``SAFE_LOG10`` — ``log10(max(x, 2e-42))``.
  * **DCT**: orthonormal DCT-II, first ``n_coefs`` rows.
  * **fingerprint value**: ``10*log10(|coef|)`` per frame and coefficient
    (/root/reference/src/fp_handler.c:651), floored at ``|coef| >= 2e-42``
    for finiteness (exact zero would be -inf in C; see PARITY.md §4).

Everything is pure NumPy so it runs identically everywhere; the JAX
implementation in :mod:`tiresias_tpu.ops.mfcc_jax` is validated against this
model by the golden tests (and on the GPU by ``chip_smoke.py``), with the
float32 error bound of :func:`fp_error_bound`.
"""

from __future__ import annotations

import numpy as np

from tiresias_tpu.config import DspConfig
from tiresias_tpu.ops.dct import dct_matrix
from tiresias_tpu.ops.melbank import mel_filterbank
from tiresias_tpu.ops.windows import hanningz

# aubio musicutils.h: #define VERY_SMALL_NUMBER 2.e-42
VERY_SMALL_NUMBER = 2e-42


def n_frames_for(n_samples: int, hop_size: int) -> int:
    """Frame count for a signal: ceil(n/hop); 0 samples → 0 frames."""
    return -(-n_samples // hop_size)


def frame_signal(pcm: np.ndarray, dsp: DspConfig) -> np.ndarray:
    """Slice a 1-D signal into pvoc-style analysis frames.

    Frame ``f`` covers samples ``[(f+1)*hop - win, (f+1)*hop)`` of the input,
    zero-padded outside ``[0, n)`` — matching aubio pvoc's zero-initialised
    sliding buffer and aubio source's zero-padded final hop.

    Returns ``[n_frames, buf_size]`` float64.
    """
    pcm = np.asarray(pcm, dtype=np.float64)
    if pcm.ndim != 1:
        raise ValueError("frame_signal expects a 1-D signal")
    hop, win = dsp.hop_size, dsp.buf_size
    n = pcm.shape[0]
    nf = n_frames_for(n, hop)
    if nf == 0:
        return np.zeros((0, win), dtype=np.float64)
    # Left-pad by win - hop (pvoc history) and right-pad the final short hop.
    padded = np.concatenate(
        [np.zeros(win - hop), pcm, np.zeros(nf * hop - n)]
    )
    frames = np.lib.stride_tricks.sliding_window_view(padded, win)[::hop][:nf]
    return np.ascontiguousarray(frames)


def magnitude_spectrum(frames: np.ndarray, dsp: DspConfig) -> np.ndarray:
    """Windowed unnormalised rFFT magnitudes: ``[n_frames, n_bins]``."""
    window = hanningz(dsp.buf_size)
    return np.abs(np.fft.rfft(frames * window, axis=-1))


def mel_energies(mags: np.ndarray, dsp: DspConfig, samplerate: float) -> np.ndarray:
    """Mel filterbank applied to magnitudes (aubio power=1)."""
    fb = mel_filterbank(dsp.n_filters, dsp.buf_size, samplerate)
    return mags @ fb.T


def log_mel(mels: np.ndarray) -> np.ndarray:
    """aubio SAFE_LOG10."""
    return np.log10(np.maximum(mels, VERY_SMALL_NUMBER))


def mfcc(log_mels: np.ndarray, dsp: DspConfig) -> np.ndarray:
    """Orthonormal DCT-II → first ``n_coefs`` coefficients."""
    dm = dct_matrix(dsp.n_filters, dsp.n_coefs)
    return log_mels @ dm.T


def fingerprint_from_coefs(coefs: np.ndarray) -> np.ndarray:
    """``10*log10(|c|)`` with the tiny-floor guard (see module docstring)."""
    return 10.0 * np.log10(np.maximum(np.abs(coefs), VERY_SMALL_NUMBER))


def fingerprint_signal(pcm: np.ndarray, samplerate: float, dsp: DspConfig | None = None) -> np.ndarray:
    """Full golden chain: 1-D PCM → ``[n_frames, n_coefs]`` fingerprint."""
    dsp = dsp or DspConfig()
    frames = frame_signal(pcm, dsp)
    mags = magnitude_spectrum(frames, dsp)
    mels = mel_energies(mags, dsp, samplerate)
    coefs = mfcc(log_mel(mels), dsp)
    return fingerprint_from_coefs(coefs)


def mfcc_signal(pcm: np.ndarray, samplerate: float, dsp: DspConfig | None = None) -> np.ndarray:
    """Golden chain up to raw MFCC coefficients (pre 10*log10|.|)."""
    dsp = dsp or DspConfig()
    frames = frame_signal(pcm, dsp)
    mags = magnitude_spectrum(frames, dsp)
    mels = mel_energies(mags, dsp, samplerate)
    return mfcc(log_mel(mels), dsp)


# float32 parity rule (tests/test_mfcc_jax.py module docstring): the
# predicted float32 noise of a stored value is a first-order propagation of
# the magnitude path's noise scale ALPHA through log10 → DCT → 10·log10|.|;
# entries predicted noisier than BOUND_CAP are skipped (noise in every
# float32 implementation, aubio's included), the rest must agree within
# EXCESS_TOL on top of their bound.
BOUND_ALPHA = 2e-5
BOUND_CAP = 0.2
EXCESS_TOL = 5e-3


def fp_error_bound(mels: np.ndarray, coefs: np.ndarray, dsp: DspConfig) -> np.ndarray:
    """Per-(frame, coef) predicted float32 noise of the stored value, from
    the float64 mel energies and raw coefficients."""
    ln10 = np.log(10.0)
    e_max = mels.max(axis=1, keepdims=True)
    rel = np.where(
        mels > 0, BOUND_ALPHA * e_max / np.maximum(mels, 1e-300), 0.0
    )
    err_c = (rel / ln10) @ np.abs(dct_matrix(dsp.n_filters, dsp.n_coefs)).T
    return (10.0 / ln10) * err_c / np.maximum(np.abs(coefs), 1e-12)


def parity_report(ours: np.ndarray, golden: np.ndarray, bound: np.ndarray) -> dict:
    """The float32-vs-oracle comparison: ``worst_excess`` (largest
    ``|ours - golden| - bound`` over covered entries — must stay below
    EXCESS_TOL), ``coverage`` (share of entries with bound < BOUND_CAP),
    and ``max_abs_diff`` over the covered entries."""
    ours = np.asarray(ours, np.float64)
    if ours.shape != golden.shape:
        raise ValueError(f"shape {ours.shape} != golden {golden.shape}")
    use = bound < BOUND_CAP
    diff = np.abs(ours - golden)
    return {
        "worst_excess": float((diff - bound)[use].max()) if use.any() else 0.0,
        "coverage": float(use.mean()),
        "max_abs_diff": float(diff[use].max()) if use.any() else 0.0,
    }


def oracle_stages(pcm: np.ndarray, samplerate: float, dsp: DspConfig | None = None):
    """(fingerprint, bound) of the float64 chain for one signal."""
    dsp = dsp or DspConfig()
    mels = mel_energies(
        magnitude_spectrum(frame_signal(pcm, dsp), dsp), dsp, samplerate
    )
    coefs = mfcc(log_mel(mels), dsp)
    return fingerprint_from_coefs(coefs), fp_error_bound(mels, coefs, dsp)
