"""G.711 µ-law / A-law wire-format support (telephony's native codec).

The reference receives channel audio from Asterisk as signed-linear
frames — the PBX has already decoded the trunk's G.711
(/root/reference/src/application_handler.c:264-302 reads `ast_read`
voice frames). A standalone serving stack has no PBX in front of it, so
the TCP protocol accepts the trunk bytes directly: one byte per 8 kHz
sample, half the wire AND host->device bytes of int16. Decode is a
256-entry table lookup that runs ON DEVICE (jnp.take inside the
fingerprint program, ops/mfcc_jax.to_float_pcm) — the chip sees uint8,
the device path sees the exact float the host decoder would have produced.

Tables follow the canonical CCITT G.711 expansion (the same Sun
Microsystems g711.c algorithm Asterisk, sox, and CPython's audioop use);
tests assert exact equality against audioop over every code point.
"""

from __future__ import annotations

import numpy as np

G711_LAWS = ("ulaw", "alaw")

# Linear wire formats accepted by the serve layer; "l16" is the default
# (base64 little-endian int16, the reference's slin). Kept here so the
# protocol and CLI validate against one list.
WIRE_FORMATS = ("l16",) + G711_LAWS

_BIAS = 0x84  # µ-law segment bias (CCITT G.711)


def _ulaw_decode_table() -> np.ndarray:
    u = np.arange(256, dtype=np.int32) ^ 0xFF  # stored complemented
    t = ((u & 0x0F) << 3) + _BIAS
    t <<= (u & 0x70) >> 4
    return np.where(u & 0x80, _BIAS - t, t - _BIAS).astype(np.int16)


def _alaw_decode_table() -> np.ndarray:
    a = np.arange(256, dtype=np.int32) ^ 0x55  # even bits inverted
    seg = (a & 0x70) >> 4
    t = (a & 0x0F) << 4
    t = np.where(seg == 0, t + 8, np.where(seg == 1, t + 0x108,
                 (t + 0x108) << np.maximum(seg - 1, 0)))
    return np.where(a & 0x80, t, -t).astype(np.int16)


ULAW_TO_I16 = _ulaw_decode_table()
ALAW_TO_I16 = _alaw_decode_table()

_DECODE = {"ulaw": ULAW_TO_I16, "alaw": ALAW_TO_I16}

# The code each law decodes nearest zero — what silence padding must use
# (a zero BYTE decodes to -32124 µ-law / -688 A-law: full-scale junk).
SILENCE_BYTE = {
    "ulaw": 0xFF,  # decodes to exactly 0
    "alaw": 0xD5,  # decodes to +8 (A-law has no exact zero)
}


def decode_table(law: str) -> np.ndarray:
    """[256] int16 expansion table for ``law`` (raises on unknown)."""
    try:
        return _DECODE[law]
    except KeyError:
        raise ValueError(
            f"unknown G.711 law {law!r} (expected one of {G711_LAWS})"
        ) from None


def decode(data: bytes | np.ndarray, law: str) -> np.ndarray:
    """Host-side G.711 → int16 (the device path does the same lookup
    on-chip; this exists for resampling, one-shot admin payloads, and
    tests)."""
    codes = np.frombuffer(data, np.uint8) if isinstance(
        data, (bytes, bytearray)
    ) else np.asarray(data)
    if codes.dtype != np.uint8:
        raise ValueError(f"G.711 codes must be uint8, got {codes.dtype}")
    return decode_table(law)[codes]


# 14-bit segment ends (the compressor works on pcm >> 2, like CPython's
# audioop / Sun g711.c "st_linear2ulaw")
_SEG_UEND = np.array(
    [0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF, 0x1FFF], np.int32
)
_ULAW_CLIP = 8159


def encode_ulaw(pcm: np.ndarray) -> np.ndarray:
    """int16 → µ-law codes (audioop/Sun linear2ulaw, vectorized; tests
    assert exact equality with audioop over all 65536 inputs).

    Exists for the client side (tools/soak.py, examples, tests) — the
    serving stack itself only ever decodes."""
    val = np.asarray(pcm, np.int32) >> 2  # arithmetic shift, like C
    neg = val < 0
    mag = np.minimum(np.where(neg, -val, val), _ULAW_CLIP) + (_BIAS >> 2)
    seg = np.searchsorted(_SEG_UEND, mag)  # first seg end >= mag
    out = np.where(
        seg >= 8,
        0x7F,
        (np.minimum(seg, 7) << 4)
        | ((mag >> (np.minimum(seg, 7) + 1)) & 0x0F),
    )
    return (out ^ np.where(neg, 0x7F, 0xFF)).astype(np.uint8)


# 13-bit segment ends (pcm >> 3)
_SEG_AEND = np.array(
    [0x1F, 0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF], np.int32
)


def encode_alaw(pcm: np.ndarray) -> np.ndarray:
    """int16 → A-law codes (audioop/Sun linear2alaw, vectorized)."""
    val = np.asarray(pcm, np.int32) >> 3
    neg = val < 0
    mag = np.where(neg, -val - 1, val)
    seg = np.searchsorted(_SEG_AEND, mag)
    segc = np.minimum(seg, 7)
    low = np.where(segc < 2, (mag >> 1) & 0x0F, (mag >> segc) & 0x0F)
    out = np.where(seg >= 8, 0x7F, (segc << 4) | low)
    return (out ^ np.where(neg, 0x55, 0xD5)).astype(np.uint8)


def encode(pcm: np.ndarray, law: str) -> np.ndarray:
    decode_table(law)  # validate the name with one error message
    return encode_ulaw(pcm) if law == "ulaw" else encode_alaw(pcm)
