"""Batched JAX/XLA fingerprint chain (the device compute path).

Redesign of the reference's per-frame serial aubio loop
(/root/reference/src/fp_handler.c:632-661): instead of one 256-sample hop at
a time through C callbacks, whole batches of signals are fingerprinted in a
single jitted computation:

    pcm [B, S] → frames [B, F, 512] → |rFFT| [B, F, 257]
        → mel (matmul) [B, F, 40] → log10 → DCT (matmul) [B, F, C]
        → 10·log10(|c|)

Design notes:
  * Framing is a reshape + concat, not a gather: with win = 2·hop, frame *f*
    is (chunk[f-1] ++ chunk[f]) of the hop-chunked signal, with a zero chunk
    for f = −1 — exactly the pvoc sliding-buffer semantics of the golden
    model (:mod:`tiresias_tpu.ops.reference_dsp`).
  * Mel apply and DCT are matmuls at HIGHEST precision; the FFT is XLA's
    (cuFFT on the GPU, O(N log N)). A DFT-as-matmul kernel measured slower
    on the GPU and was removed (PERF.md, Findings).
  * All shapes static; variable-length audio is padded on the host to
    bucketed frame counts (see :func:`pad_frames_bucket`) and carries an
    explicit ``n_frames`` so downstream masking is exact.
"""

from __future__ import annotations

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np

from tiresias_tpu.config import DspConfig
from tiresias_tpu.ops.dct import dct_matrix
from tiresias_tpu.ops.melbank import mel_filterbank
from tiresias_tpu.ops.reference_dsp import VERY_SMALL_NUMBER, n_frames_for
from tiresias_tpu.ops.windows import hanningz

# Padding value for fingerprint frames that don't exist. 10*log10(2e-42) is
# the floor of real values (PARITY.md D1); padding sits far below it so no
# tolerance band can ever match padding.
PAD_VALUE = -1e6

# aubio's SAFE_LOG10 floor is 2e-42, a float32 *subnormal* — accelerators
# may flush subnormals to zero, so max(x, 2e-42) silently becomes
# max(x, 0) on device
# and log10 of empty mel filters would be -inf. Instead: values below the
# smallest safe normal threshold map to the exact aubio constant
# log10(2e-42); values in [2e-42, 1e-37) would differ from aubio by <5 in the
# log, a measure-zero band for real signals (PARITY.md §2 log stage).
_FLOOR_THRESHOLD = 1e-37
_LOG10_FLOOR = float(np.log10(VERY_SMALL_NUMBER))


def safe_log10(x: jax.Array) -> jax.Array:
    """aubio SAFE_LOG10, robust to subnormal flushing."""
    return jnp.where(
        x >= _FLOOR_THRESHOLD,
        jnp.log10(jnp.maximum(x, _FLOOR_THRESHOLD)),
        _LOG10_FLOOR,
    )


@functools.lru_cache(maxsize=32)
def dsp_constants(dsp: DspConfig, samplerate: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(window [win], mel_T [n_bins, n_filters], dct_T [n_filters, n_coefs])."""
    window = hanningz(dsp.buf_size, dtype=np.float32)
    mel_t = mel_filterbank(dsp.n_filters, dsp.buf_size, samplerate).T.astype(np.float32)
    dct_t = dct_matrix(dsp.n_filters, dsp.n_coefs).T.astype(np.float32)
    return window, mel_t, dct_t


def coef_scale_for(dsp: DspConfig) -> np.ndarray | None:
    """``1 / coef_weights`` as a ``[n_coefs]`` f32 row, or None.

    The stored value space is LOG-domain (``10*log10|mfcc|``), so the
    round-5 per-coef noise weighting must SCALE the log values — a DCT
    column scale would only shift them additively, leaving |q - d|
    untouched. Every fingerprint entry point multiplies its output by
    this row (one fused elementwise op; None = reference parity), which
    puts ingest and queries in the weighted space where a scalar search
    tolerance ``t`` means the per-coef tolerance ``t * w_c``."""
    if dsp.coef_weights is None:
        return None
    return (
        1.0 / np.asarray(dsp.coef_weights, np.float32)
    ).astype(np.float32)


_device_consts_lock = threading.Lock()


def cache_device_constants(cache: dict, key, build, maxsize: int = 16):
    """Shared device-constant cache.

    NOT an lru_cache: under a jit trace ``jnp.asarray`` of a host array
    yields a constant tracer, and caching one leaks it out of its trace
    (observed UnexpectedTracerError on the next call). Traced calls embed
    the constants into the enclosing jaxpr and are never cached. Bounded:
    oldest entry evicted past ``maxsize`` (native-rate corpora can touch
    many samplerates). The get/evict/insert sequence is locked: the serve
    layer searches concurrently on executor threads (scorer tick + hangup
    flush), and racing evictions on a plain dict can double-evict or raise
    mid-iteration. ``build`` runs outside the lock — it may dispatch device
    work; a duplicate concurrent build is harmless."""
    hit = cache.get(key)
    if hit is not None:
        return hit
    out = build()
    if not any(isinstance(o, jax.core.Tracer) for o in out):
        with _device_consts_lock:
            while len(cache) >= maxsize:
                cache.pop(next(iter(cache)), None)
            cache[key] = out
    return out


_device_consts_cache: dict = {}


def _device_dsp_constants(dsp: DspConfig, samplerate: int):
    """Device-resident :func:`dsp_constants` — uploaded once per
    (dsp, samplerate) instead of on every dispatch."""
    def build():
        window, mel_t, dct_t = dsp_constants(dsp, samplerate)
        return jnp.asarray(window), jnp.asarray(mel_t), jnp.asarray(dct_t)

    return cache_device_constants(
        _device_consts_cache, (dsp, samplerate), build
    )


def frames_from_pcm(pcm: jax.Array, hop_size: int, buf_size: int) -> jax.Array:
    """pvoc-style framing on device.

    Args:
      pcm: ``[..., S]`` with S a multiple of ``hop_size`` (host pads).
    Returns:
      ``[..., F, buf_size]`` with F = S // hop_size; frame f covers input
      samples ``[(f+1)*hop - win, (f+1)*hop)`` (zeros before t=0).
    """
    if buf_size % hop_size != 0:
        raise ValueError("buf_size must be a multiple of hop_size")
    k = buf_size // hop_size
    *lead, s = pcm.shape
    if s % hop_size != 0:
        raise ValueError("signal length must be a multiple of hop_size")
    f = s // hop_size
    chunks = pcm.reshape(*lead, f, hop_size)
    zero = jnp.zeros((*lead, 1, hop_size), dtype=pcm.dtype)
    parts = []
    for back in range(k - 1, -1, -1):
        if back == 0:
            parts.append(chunks)
        else:
            shifted = jnp.concatenate(
                [jnp.broadcast_to(zero, (*lead, back, hop_size)), chunks[..., :-back, :]],
                axis=-2,
            )
            parts.append(shifted)
    return jnp.concatenate(parts, axis=-1)


def to_float_pcm(pcm: jax.Array, law: str | None = None) -> jax.Array:
    """Device-side wire format → float32 (aubio's s/32768 source scaling).

    int16 ships as-is and scales on device (half the H2D bytes of f32);
    G.711 µ-law/A-law ships as uint8 (``law`` names the expansion —
    telephony's native trunk bytes, ONE byte per sample) and decodes on
    device via a 256-entry table gather. The f32 table is the exact int16
    expansion divided by 32768 (every int16/32768 is exactly representable
    in f32), so both paths are bit-identical to decoding on host.
    """
    if pcm.dtype == jnp.uint8:
        if law is None:
            raise ValueError(
                "uint8 PCM requires a G.711 law (pass wire_law=...)"
            )
        from tiresias_tpu.utils.g711 import decode_table

        table = jnp.asarray(
            decode_table(law).astype(np.float32) / np.float32(32768.0)
        )
        return jnp.take(table, pcm.astype(jnp.int32))
    if pcm.dtype == jnp.int16:
        return pcm.astype(jnp.float32) * jnp.float32(1.0 / 32768.0)
    return pcm.astype(jnp.float32)


def spectral_chain(
    frames: jax.Array,
    window: jax.Array,
    mel_t: jax.Array,
    dct_t: jax.Array,
) -> jax.Array:
    """Frames ``[..., F, buf_size]`` → fingerprint ``[..., F, n_coefs]``:
    window → |rFFT| → mel → log10 → DCT → ``10·log10|c|``.

    The ONE parity-sensitive post-framing implementation, shared by the
    batch path and the sequence-parallel shard function
    (parallel/sharding.py) — a fix here (precision, log floor) must reach
    both or the sharded fingerprint silently diverges from single-device.

    HIGHEST precision: a float32 matmul may otherwise run in TF32 (or
    bf16) on an accelerator, which is visible (±0.03) in the log-log
    fingerprint domain and would break aubio parity. These matmuls are a
    negligible share of the chain's cost.
    """
    mags = jnp.abs(jnp.fft.rfft(frames * window, axis=-1))
    mels = jnp.matmul(
        mags, mel_t, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    coefs = jnp.matmul(
        safe_log10(mels), dct_t, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return 10.0 * safe_log10(jnp.abs(coefs))


def mask_valid_samples(
    pcm_f: jax.Array, n_valid: jax.Array | None
) -> jax.Array:
    """Zero decoded samples at/beyond each signal's true length.

    G.711 batches pad with the law's silence CODE, but A-law's quietest
    code decodes to +8 (it has no exact zero) — without this mask the
    tail-straddling frames would differ from the linear path's zero
    padding and break bitwise parity across wire formats."""
    if n_valid is None:
        return pcm_f
    idx = jnp.arange(pcm_f.shape[-1])[None, :]
    return jnp.where(idx < n_valid[:, None], pcm_f, 0.0)


@functools.partial(
    jax.jit, static_argnames=("hop_size", "buf_size", "law")
)
def _fingerprint_padded(
    pcm: jax.Array,
    window: jax.Array,
    mel_t: jax.Array,
    dct_t: jax.Array,
    hop_size: int,
    buf_size: int,
    law: str | None = None,
    n_valid: jax.Array | None = None,
) -> jax.Array:
    """[B, S] float32/int16/G.711-uint8 → [B, F, n_coefs] values."""
    pcm_f = mask_valid_samples(to_float_pcm(pcm, law), n_valid)
    frames = frames_from_pcm(pcm_f, hop_size, buf_size)
    return spectral_chain(frames, window, mel_t, dct_t)


def fingerprint_padded_batch(
    pcm: jax.Array | np.ndarray,
    samplerate: int,
    dsp: DspConfig | None = None,
    law: str | None = None,
    n_valid: jax.Array | np.ndarray | None = None,
) -> jax.Array:
    """Fingerprint a pre-padded batch ``[B, S]`` (S multiple of hop).

    ``law`` names the G.711 expansion for uint8 batches (wire bytes
    reach the device undecoded — see :func:`to_float_pcm`); ``n_valid``
    [B] gives each signal's true sample count so decoded padding is
    zeroed exactly (see :func:`mask_valid_samples`)."""
    dsp = dsp or DspConfig()
    if n_valid is not None:
        n_valid = jnp.asarray(n_valid, jnp.int32)
    scale = coef_scale_for(dsp)  # round-5 noise weighting (None = parity)
    window, mel_t, dct_t = _device_dsp_constants(dsp, int(samplerate))
    pcm = jnp.asarray(pcm)  # int16/uint8 stays raw (converted on device)
    out = _fingerprint_padded(
        pcm, window, mel_t, dct_t, dsp.hop_size, dsp.buf_size, law=law,
        n_valid=n_valid,
    )
    return out if scale is None else out * jnp.asarray(scale)


def bucket_frames(
    n_frames: int, multiple: int = 128, minimum: int | None = None
) -> int:
    """Round a frame count up to a bucket so jit recompiles stay bounded.

    ``minimum`` defaults to ``multiple`` (one full bucket)."""
    if minimum is None:
        minimum = multiple
    if n_frames <= minimum:
        return minimum
    return -(-n_frames // multiple) * multiple


def pad_frames_bucket(
    pcms: list[np.ndarray], hop_size: int, multiple: int = 128,
    law: str | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Pad a ragged list of 1-D signals to one bucketed [B, S] array.

    Returns (padded [B, F_bucket*hop], n_frames int32 [B]). The batch stays
    int16 when every input is int16 (half the H2D bytes; converted on
    device by :func:`to_float_pcm`), float32 otherwise. With ``law``
    (G.711 wire batches) every signal must be uint8 codes; the batch stays
    uint8 — ONE byte per sample over the link — and pads with the law's
    silence code (a zero BYTE is full-scale linear, g711.SILENCE_BYTE).
    """
    n_frames = np.array([n_frames_for(len(p), hop_size) for p in pcms], dtype=np.int32)
    f_bucket = bucket_frames(int(n_frames.max(initial=1)), multiple)
    if law is not None:
        from tiresias_tpu.utils.g711 import SILENCE_BYTE, decode_table

        decode_table(law)  # validate the name early
        for i, p in enumerate(pcms):
            if np.asarray(p).dtype != np.uint8:
                raise ValueError(
                    f"wire_law={law!r} requires uint8 G.711 codes; "
                    f"signal {i} is {np.asarray(p).dtype}"
                )
        out = np.full(
            (len(pcms), f_bucket * hop_size), SILENCE_BYTE[law], np.uint8
        )
        for i, p in enumerate(pcms):
            out[i, : len(p)] = np.asarray(p)
        return out, n_frames
    dtype = (
        np.int16
        if pcms and all(np.asarray(p).dtype == np.int16 for p in pcms)
        else np.float32
    )
    out = np.zeros((len(pcms), f_bucket * hop_size), dtype=dtype)
    for i, p in enumerate(pcms):
        p = np.asarray(p)
        if p.dtype == np.uint8:
            raise ValueError(
                f"signal {i} is uint8 (G.711 codes?) but no wire_law "
                "was given"
            )
        if dtype == np.float32 and p.dtype == np.int16:
            # mixed batch falls back to float: scale int16 here, since the
            # device-side to_float_pcm only scales int16-dtype batches
            p = p.astype(np.float32) / 32768.0
        elif p.dtype != np.int16 and len(p) and not np.isfinite(p).all():
            # NaN/Inf samples collapse to floor fingerprints that spuriously
            # match silence — reject at the shared input layer so every
            # caller (search, add_audio_pcm, serving) is guarded
            raise ValueError(f"non-finite samples in signal {i}")
        out[i, : len(p)] = p.astype(dtype)
    return out, n_frames


def fingerprint_signals_async(
    pcms: list[np.ndarray],
    samplerate: int,
    dsp: DspConfig | None = None,
    bucket_multiple: int = 128,
    law: str | None = None,
) -> tuple[jax.Array, np.ndarray]:
    """Dispatch a ragged-batch fingerprint WITHOUT the host readback.

    Returns (fp device array [B, F_bucket, n_coefs] — padding frames NOT
    masked, see :func:`mask_fingerprints` — and n_frames [B] int32 on host).
    JAX dispatch is asynchronous, so the caller can overlap further host
    work (decode, hashing, store writes) with device execution and only
    pay the sync when it reads the result — the producer/consumer ingest
    pipeline (engine/sync.py) is built on this.
    """
    dsp = dsp or DspConfig()
    padded, n_frames = pad_frames_bucket(
        pcms, dsp.hop_size, bucket_multiple, law=law
    )
    n_valid = (
        np.array([len(p) for p in pcms], np.int32) if law is not None
        else None
    )
    return (
        fingerprint_padded_batch(
            padded, samplerate, dsp, law=law, n_valid=n_valid
        ),
        n_frames,
    )


def mask_fingerprints(fp: np.ndarray, n_frames: np.ndarray) -> np.ndarray:
    """Overwrite frames beyond each signal's count with PAD_VALUE."""
    mask = np.arange(fp.shape[1])[None, :] < n_frames[:, None]
    return np.where(mask[:, :, None], fp, PAD_VALUE).astype(np.float32)


def fingerprint_signals(
    pcms: list[np.ndarray],
    samplerate: int,
    dsp: DspConfig | None = None,
    bucket_multiple: int = 128,
) -> tuple[np.ndarray, np.ndarray]:
    """Fingerprint a ragged batch of signals.

    Returns (fp [B, F_bucket, n_coefs] float32 with PAD_VALUE beyond each
    signal's frames, n_frames [B] int32).
    """
    fp_dev, n_frames = fingerprint_signals_async(
        pcms, samplerate, dsp, bucket_multiple
    )
    return mask_fingerprints(np.asarray(fp_dev), n_frames), n_frames


def fingerprint_signal(
    pcm: np.ndarray, samplerate: int, dsp: DspConfig | None = None
) -> np.ndarray:
    """Single signal → exact-length ``[n_frames, n_coefs]`` fingerprint."""
    dsp = dsp or DspConfig()
    fp, n_frames = fingerprint_signals([np.asarray(pcm)], samplerate, dsp)
    return fp[0, : int(n_frames[0])]
