"""Frozen golden-fixture tests (tamper-evident DSP baseline).

The committed ``tests/goldens/mfcc_goldens.npz`` freezes every sub-stage of
the float64 oracle over the canonical corpus (generated once by
``tools/make_goldens.py``). Both the oracle itself AND the live float32
paths are compared against the *file*: editing
``tiresias_tpu/ops/reference_dsp.py`` (or windows/melbank/dct) alone now
fails these tests instead of silently re-baselining everything —
Reference numerics anchored at
/root/reference/src/fp_handler.c:632-661.
"""

import os

import numpy as np
import pytest

from golden_corpus import MIN_COVERAGE, all_cases
from tiresias_tpu.config import DspConfig
from tiresias_tpu.ops import mfcc_jax, reference_dsp as rdsp

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "mfcc_goldens.npz")

@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDENS)


def _bound_from_fixture(g, name, dsp):
    """Float32 error-propagation bound computed from FROZEN stages only."""
    return rdsp.fp_error_bound(g[f"{name}/mels"], g[f"{name}/coefs"], dsp)


CASE_NAMES = sorted(all_cases())


@pytest.mark.parametrize("name", CASE_NAMES)
def test_oracle_matches_frozen_fixture(goldens, name):
    """The float64 oracle must reproduce the frozen stages bit-for-bit (up
    to cross-platform FFT rounding). An edit to reference_dsp.py,
    windows.py, melbank.py or dct.py fails HERE, not by re-baselining."""
    make_pcm, sr = all_cases()[name]
    dsp = DspConfig()
    pcm = np.asarray(make_pcm(), dtype=np.float64)
    frames = rdsp.frame_signal(pcm, dsp)
    mags = rdsp.magnitude_spectrum(frames, dsp)
    mels = rdsp.mel_energies(mags, dsp, sr)
    logm = rdsp.log_mel(mels)
    coefs = rdsp.mfcc(logm, dsp)
    fp = rdsp.fingerprint_from_coefs(coefs)
    assert int(goldens[f"{name}/samplerate"]) == sr
    np.testing.assert_allclose(mags, goldens[f"{name}/mags"], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(mels, goldens[f"{name}/mels"], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(logm, goldens[f"{name}/logmel"], rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(coefs, goldens[f"{name}/coefs"], rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(fp, goldens[f"{name}/fp"], rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_live_path_matches_frozen_fixture(goldens, name):
    """The float32 XLA fingerprint path vs the FROZEN final values, using
    the frozen-stage error-propagation bound (see tests/test_mfcc_jax.py's
    module docstring for the bound's derivation)."""
    make_pcm, sr = all_cases()[name]
    dsp = DspConfig()
    ours = np.asarray(mfcc_jax.fingerprint_signal(make_pcm(), sr, dsp))
    rep = rdsp.parity_report(
        ours, goldens[f"{name}/fp"], _bound_from_fixture(goldens, name, dsp)
    )
    assert rep["coverage"] >= MIN_COVERAGE[name], "bound excludes too much — vacuous"
    assert rep["worst_excess"] < rdsp.EXCESS_TOL, f"max excess diff {rep}"


def test_fixture_is_committed_and_versioned(goldens):
    assert int(goldens["__version__"]) == 1
    # every case has all five frozen stages
    for name in CASE_NAMES:
        for stage in ("mags", "mels", "logmel", "coefs", "fp"):
            assert f"{name}/{stage}" in goldens
