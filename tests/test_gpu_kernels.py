"""The Triton kernels compiled for the card, against the XLA form.

Card-only: every test takes the ``gpu`` fixture, which skips when JAX finds
no GPU. On a GPU machine run ``JAX_PLATFORMS=cuda python -m pytest tests/
-m gpu``; ``chip_smoke.py`` (phase "kernels") runs the same comparison at
full width. The CPU tests cover the same kernels in the Pallas interpreter
(tests/test_match_pallas.py).
"""

import numpy as np
import pytest

from tiresias_tpu.ops import match_jax
from tiresias_tpu.ops.mfcc_jax import PAD_VALUE

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs this on the card)")


def _db(rng, a, t, c):
    db = rng.uniform(-30, 20, size=(a, t, c)).astype(np.float32)
    nf = rng.integers(t // 2, t + 1, size=a)
    mask = np.arange(t)[None, :] < nf[:, None]
    return np.where(mask[:, :, None], db, PAD_VALUE).astype(np.float32), mask


@pytest.mark.parametrize("aligned,shape,coefs", [
    (False, (4096, 128, 2), 2),
    (True, (2048, 256, 8), 8),
])
def test_compiled_kernel_matches_xla(gpu, aligned, shape, coefs):
    import jax

    from tiresias_tpu.ops.match_pallas import fused_votes

    rng = np.random.default_rng(3)
    db, mask = _db(rng, *shape)
    q = db[[5, 77, 901], 8:60] + rng.normal(0, 0.01, (3, 52, shape[2]))
    qj, act, u2 = match_jax.prepare_query(q.astype(np.float32), None,
                                          trunc_coef1=False)
    fn = jax.jit(lambda d, q, a, u: fused_votes(
        d, q, a, u, 0.1, coefs=coefs, aligned=aligned))
    hlo = fn.lower(db, qj, act, u2).as_text()
    assert "xla.gpu.triton" in hlo
    got = np.asarray(fn(db, qj, act, u2))
    want = np.asarray(match_jax.match_votes(
        db, mask, qj, act, u2, 0.1, coefs=coefs, aligned=aligned))
    np.testing.assert_array_equal(got, want)


def test_compiled_rescore_rows_match_gather(gpu):
    from tiresias_tpu.ops.match_pallas import fused_votes

    rng = np.random.default_rng(4)
    db, mask = _db(rng, 3000, 128, 2)
    q = db[[10, 20], 4:40]
    qj, act, u2 = match_jax.prepare_query(q, None, trunc_coef1=False)
    rows = rng.integers(0, 3000, size=(2, 1024)).astype(np.int32)
    for aligned in (False, True):
        got = np.asarray(fused_votes(db, qj, act, u2, 0.05, coefs=2,
                                     aligned=aligned, rows=rows))
        full = np.asarray(match_jax.match_votes(
            db, mask, qj, act, u2, 0.05, coefs=2, aligned=aligned))
        np.testing.assert_array_equal(got, np.take_along_axis(full, rows, 1))
