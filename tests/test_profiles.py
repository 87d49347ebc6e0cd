"""Analysis profiles + multi-samplerate golden parity.

The reference analyses at each file's native rate (DEF_AUBIO_SAMPLERATE 0,
/root/reference/src/fp_handler.c:37,612); the JAX chains must match
the float64 golden model at every deployment samplerate and profile, not
just 8 kHz telephony.
"""

import numpy as np
import pytest

from tiresias_tpu.ops import reference_dsp
from tiresias_tpu.ops.mfcc_jax import fingerprint_padded_batch, fingerprint_signal
from tiresias_tpu.profiles import MUSIC, PROFILES, TELEPHONY, WIDEBAND, get_profile


def _speechy(rng, sr: float, seconds: float = 0.4) -> np.ndarray:
    """Broadband signal (sum of harmonics + noise) — the trustworthy regime
    of the float32 noise-floor analysis (PARITY.md §2)."""
    t = np.arange(int(sr * seconds)) / sr
    sig = sum(
        a * np.sin(2 * np.pi * f * t)
        for a, f in [(0.3, 210), (0.2, 420), (0.15, 840), (0.1, 1680)]
    )
    sig = sig + 0.05 * rng.standard_normal(len(t))
    return sig.astype(np.float32)


class TestProfiles:
    def test_registry(self):
        assert set(PROFILES) == {"telephony", "wideband", "music"}
        assert get_profile("music") is MUSIC
        with pytest.raises(KeyError):
            get_profile("nope")

    def test_telephony_is_reference_parity(self):
        assert TELEPHONY.dsp.hop_size == 256
        assert TELEPHONY.dsp.buf_size == 512
        assert TELEPHONY.dsp.n_filters == 40
        assert TELEPHONY.dsp.n_coefs == 2
        assert TELEPHONY.match.coefs == 1
        assert TELEPHONY.match.trunc_coef1 is True
        assert TELEPHONY.match.tolerance == 0.001


@pytest.mark.parametrize(
    "profile,sr",
    [(TELEPHONY, 8000), (WIDEBAND, 16000), (MUSIC, 44100), (TELEPHONY, 16000)],
)
class TestMultiRateGolden:
    def test_jax_matches_golden(self, profile, sr, rng):
        pcm = _speechy(rng, sr)
        golden = reference_dsp.fingerprint_signal(pcm, sr, profile.dsp)
        got = fingerprint_signal(pcm, sr, profile.dsp)
        assert got.shape == golden.shape
        # broadband signals: float32 vs float64 rounding only
        close = np.abs(got - golden) <= 0.02
        assert close.mean() > 0.95, f"{close.mean():.3f} within tolerance"

    def test_pallas_matches_golden(self, profile, sr, rng):
        """The padded-batch entry point (the device path every search and
        ingest batch takes) against the golden model."""
        pcm = _speechy(rng, sr)
        golden = reference_dsp.fingerprint_signal(pcm, sr, profile.dsp)
        hop = profile.dsp.hop_size
        n = len(pcm) // hop * hop
        got = np.asarray(
            fingerprint_padded_batch(pcm[None, :n], sr, profile.dsp)
        )[0]
        golden = golden[: got.shape[0]]
        close = np.abs(got - golden) <= 0.02
        assert close.mean() > 0.95, f"{close.mean():.3f} within tolerance"
