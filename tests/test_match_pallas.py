"""Fused matchers (Triton kernels) vs the XLA matcher and the Python oracle.

The kernels run in the Pallas interpreter on the CPU; they must reproduce
the reference semantics exactly (integer vote counts — comparisons are
equalities, not tolerances). The platform choice is checked by lowering
for ``cuda`` without a GPU.
"""

import numpy as np
import pytest

from tiresias_tpu.ops import match_jax
from tiresias_tpu.ops.match_pallas import search_batch_pallas
from tiresias_tpu.ops.match_ref import search_reference
from tiresias_tpu.ops.mfcc_jax import PAD_VALUE


def _random_db(rng, n_audios=37, t=128, c=2):
    db = rng.uniform(-40, 30, size=(n_audios, t, c)).astype(np.float32)
    n_frames = rng.integers(1, t + 1, size=n_audios)
    mask = np.arange(t)[None, :] < n_frames[:, None]
    db = np.where(mask[:, :, None], db, PAD_VALUE).astype(np.float32)
    return db, mask, n_frames


@pytest.mark.parametrize("coefs", [1, 2])
@pytest.mark.parametrize("tolerance", [0.001, 0.9, 2.5])
def test_matches_xla(rng, coefs, tolerance):
    db, mask, n_frames = _random_db(rng)
    q = rng.uniform(-40, 30, size=(3, 32, 2)).astype(np.float32)
    qf = rng.integers(1, 32, size=3).astype(np.int32)
    _, _, votes_p = search_batch_pallas(
        db, q, qf, coefs=coefs, tolerance=tolerance, interpret=True
    )
    _, _, votes_x = match_jax.search_batch(
        db, mask, q, qf, coefs=coefs, tolerance=tolerance
    )
    np.testing.assert_array_equal(np.asarray(votes_p), np.asarray(votes_x))


@pytest.mark.parametrize("trunc", [True, False])
def test_matches_oracle_with_band(rng, trunc):
    db, mask, n_frames = _random_db(rng, n_audios=9)
    q = rng.uniform(-40, 30, size=(2, 24, 2)).astype(np.float32)
    best, count, votes = search_batch_pallas(
        db, q, None, coefs=2, tolerance=0.8,
        freq_ignore_low=25, freq_ignore_high=400,
        trunc_coef1=trunc, interpret=True,
    )
    db_list = [db[i, : n_frames[i]] for i in range(db.shape[0])]
    for b in range(2):
        ref = search_reference(
            db_list, q[b], coefs=2, tolerance=0.8,
            freq_ignore_low=25, freq_ignore_high=400, trunc_coef1=trunc,
        )
        np.testing.assert_array_equal(np.asarray(votes[b]), ref.votes)
        assert int(count[b]) == ref.match_count


def test_audio_padding_gets_no_votes(rng):
    # 37 audios → padded to whole audio tiles inside the kernel; votes
    # sliced back
    db, mask, _ = _random_db(rng, n_audios=37)
    q = rng.uniform(-40, 30, size=(1, 16, 2)).astype(np.float32)
    _, _, votes = search_batch_pallas(
        db, q, None, coefs=1, tolerance=5.0, interpret=True
    )
    assert np.asarray(votes).shape == (1, 37)


def test_empty_frames_inactive(rng):
    db, mask, _ = _random_db(rng, n_audios=5)
    q = rng.uniform(-40, 30, size=(2, 16, 2)).astype(np.float32)
    qf = np.array([0, 16], dtype=np.int32)  # first query has no valid frames
    _, count, votes = search_batch_pallas(
        db, q, qf, coefs=1, tolerance=5.0, interpret=True
    )
    assert (np.asarray(votes)[0] == 0).all()
    assert int(count[0]) == 0


class TestAlignedKernel:
    """Offset-consistent (aligned) fused kernel vs the XLA aligned matcher."""

    @pytest.mark.parametrize("coefs", [1, 2])
    @pytest.mark.parametrize("tolerance", [0.5, 2.5])
    def test_matches_xla_aligned(self, rng, coefs, tolerance):
        db, mask, n_frames = _random_db(rng)
        q = rng.uniform(-40, 30, size=(3, 32, 2)).astype(np.float32)
        qf = rng.integers(1, 32, size=3).astype(np.int32)
        _, _, votes_p = search_batch_pallas(
            db, q, qf, coefs=coefs, tolerance=tolerance, aligned=True,
            interpret=True,
        )
        _, _, votes_x = match_jax.search_batch(
            db, mask, q, qf, coefs=coefs, tolerance=tolerance, aligned=True
        )
        np.testing.assert_array_equal(np.asarray(votes_p), np.asarray(votes_x))

    def test_multicoef_aligned(self, rng):
        """The recommended accuracy mode: 8 coefs + no truncation."""
        db, mask, n_frames = _random_db(rng, n_audios=17, c=8)
        q = rng.uniform(-40, 30, size=(2, 24, 8)).astype(np.float32)
        _, _, votes_p = search_batch_pallas(
            db, q, None, coefs=8, tolerance=1.0, trunc_coef1=False,
            aligned=True, interpret=True,
        )
        _, _, votes_x = match_jax.search_batch(
            db, mask, q, None, coefs=8, tolerance=1.0, trunc_coef1=False,
            aligned=True,
        )
        np.testing.assert_array_equal(np.asarray(votes_p), np.asarray(votes_x))

    def test_aligned_beats_bag_on_shifted_copy(self, rng):
        """A time-shifted exact copy scores full votes aligned; a
        frame-shuffled copy (same bag of frames!) scores much lower."""
        t = 128
        base = rng.uniform(-40, 30, size=(t, 2)).astype(np.float32)
        shuffled = base[rng.permutation(t)]
        db = np.stack([base, shuffled])
        q = base[None, 32:64]  # an excerpt
        _, _, votes = search_batch_pallas(
            db, q, None, coefs=2, tolerance=0.01, trunc_coef1=False,
            aligned=True, interpret=True,
        )
        votes = np.asarray(votes)
        assert votes[0, 0] == 32  # perfect alignment on the original
        assert votes[0, 1] < 32  # shuffled copy has no consistent offset

    def test_window_wider_than_chunk(self, rng):
        """The query span exceeds one offset tile (F − 1 > O_t): each
        program sees only part of the window's offsets and the max over
        offset tiles runs in XLA. Must still equal the XLA matcher
        bit-for-bit."""
        import tiresias_tpu.ops.match_pallas as mp

        assert 96 - 1 > mp.ALIGNED_O_TILE
        db = rng.uniform(-30, 20, size=(3, 256, 2)).astype(np.float32)
        db[1, 240:] = PAD_VALUE
        q = db[1, 100:196][None]  # 96-frame excerpt straddling tiles
        qj, active, use2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        votes_p = mp.fused_votes(
            db, qj, active, use2, 0.1, coefs=2, aligned=True, interpret=True
        )
        mask = db[:, :, 0] > -1e5
        votes_x = match_jax.match_votes(
            db, mask, qj, active, use2, 0.1, coefs=2, aligned=True
        )
        np.testing.assert_array_equal(np.asarray(votes_p), np.asarray(votes_x))


class TestAlignedPrefilter:
    """Certified two-stage aligned search: lattice bound -> top-k exact
    rescore. Must equal the full aligned scan whenever the certificate
    holds, and must refuse the certificate on pathological corpora."""

    def _db(self, rng, n_audios, t=128, c=2):
        db = rng.uniform(-40, 30, size=(n_audios, t, c)).astype(np.float32)
        # >= 96 valid frames so the 10:42 / 40:72 query excerpts below are
        # always real (not PAD) frames
        n_frames = rng.integers(96, t + 1, size=n_audios)
        mask = np.arange(t)[None, :] < n_frames[:, None]
        db = np.where(mask[:, :, None], db, PAD_VALUE).astype(np.float32)
        return db, mask

    def test_matches_full_aligned_when_certified(self, rng):
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import build_bound_maps
        from tiresias_tpu.ops.match_pallas import aligned_prefiltered_votes

        db, mask = self._db(rng, n_audios=64)
        specs, maps = build_bound_maps(jnp.asarray(db), jnp.asarray(mask))
        # queries: excerpts of two stored audios (certain winners)
        q = np.stack([db[7, 10:42, :], db[31, 40:72, :]]).astype(np.float32)
        qj, active, use2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        votes_p, cert = aligned_prefiltered_votes(
            db, maps, qj, active, use2, 0.05, specs=specs, coefs=2, k=8,
            interpret=True,
        )
        assert np.asarray(cert).all()
        _, _, votes_full = match_jax.search_batch(
            db, mask, q, None, coefs=2, tolerance=0.05, trunc_coef1=False,
            aligned=True,
        )
        votes_p, votes_full = np.asarray(votes_p), np.asarray(votes_full)
        # winner and its count are identical; non-candidates may be zeroed
        # but can never beat the certified winner
        for b in range(2):
            assert votes_p[b].argmax() == votes_full[b].argmax()
            assert votes_p[b].max() == votes_full[b].max()
            assert (votes_full[b] < votes_p[b].max()).sum() >= 62

    def test_certificate_fails_on_duplicates(self, rng):
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import build_bound_maps
        from tiresias_tpu.ops.match_pallas import aligned_prefiltered_votes

        base = rng.uniform(-40, 30, size=(64, 2)).astype(np.float32)
        db = np.broadcast_to(base, (16, 64, 2)).copy()  # 16 identical audios
        mask = np.ones((16, 64), bool)
        specs, maps = build_bound_maps(jnp.asarray(db), jnp.asarray(mask))
        q = base[None, 8:24]
        qj, active, use2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        _, cert = aligned_prefiltered_votes(
            db, maps, qj, active, use2, 0.05, specs=specs, coefs=2, k=4,
            interpret=True,
        )
        assert not np.asarray(cert).any()  # k-th bound ties the winner

    def test_k_covering_all_is_always_certified(self, rng):
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import build_bound_maps
        from tiresias_tpu.ops.match_pallas import aligned_prefiltered_votes

        db, mask = self._db(rng, n_audios=12)
        specs, maps = build_bound_maps(jnp.asarray(db), jnp.asarray(mask))
        q = rng.uniform(-40, 30, size=(1, 24, 2)).astype(np.float32)
        qj, active, use2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        votes_p, cert = aligned_prefiltered_votes(
            db, maps, qj, active, use2, 1.0, specs=specs, coefs=2, k=64,
            interpret=True,
        )
        assert np.asarray(cert).all()
        _, _, votes_full = match_jax.search_batch(
            db, mask, q, None, coefs=2, tolerance=1.0, trunc_coef1=False,
            aligned=True,
        )
        np.testing.assert_array_equal(
            np.asarray(votes_p), np.asarray(votes_full)
        )

    def test_bound_coefs_subset_of_search_coefs(self):
        """A bound on a coef the aligned condition does not test would be
        unsound — the selection must stay within the search's coefs."""
        from tiresias_tpu.ops.match_lattice import bound_coef_indices

        for n in range(1, 9):
            assert all(c < n for c in bound_coef_indices(n))
        assert bound_coef_indices(1) == (0,)
        # 2-coef: BOTH coefs — min over more valid bounds is strictly
        # tighter, and coef 1 alone cannot separate wide-spectrum
        # corpora (round-5 strict-bag fast path)
        assert bound_coef_indices(2) == (0, 1)
        assert bound_coef_indices(8) == (1, 2)

    def test_search_coefs_fewer_than_stored(self, rng):
        """Search with coefs=2 over an 8-coef store: the bound tests
        exactly the searched coefs {0, 1}, and the certified result must
        equal the full scan."""
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import build_bound_maps
        from tiresias_tpu.ops.match_pallas import aligned_prefiltered_votes

        db, mask = self._db(rng, n_audios=32, c=8)
        specs, maps = build_bound_maps(
            jnp.asarray(db), jnp.asarray(mask), coefs=2
        )
        assert [s[0] for s in specs] == [0, 1]
        q = db[None, 9, 10:42, :].astype(np.float32)
        qj, active, use2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        votes_p, cert = aligned_prefiltered_votes(
            db, maps, qj, active, use2, 0.05, specs=specs, coefs=2, k=8,
            interpret=True,
        )
        assert np.asarray(cert).all()
        _, _, votes_full = match_jax.search_batch(
            db, mask, q, None, coefs=2, tolerance=0.05, trunc_coef1=False,
            aligned=True,
        )
        assert np.asarray(votes_p)[0].argmax() == np.asarray(votes_full)[0].argmax() == 9
        assert np.asarray(votes_p)[0].max() == np.asarray(votes_full)[0].max()

    @pytest.mark.parametrize("coefs", [1, 2, 8])
    @pytest.mark.parametrize("tolerance", [0.01, 0.1, 1.0])
    def test_bound_dominates_true_aligned_score(self, rng, coefs, tolerance):
        """THE core inequality (bound validity): for every audio, the
        clipped-scaled uint8-quantized lattice bound must be >= the true
        aligned score — for any corpus, tolerance, or coef count."""
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import build_bound_maps, bound_votes

        c = max(coefs, 2)
        db, mask = self._db(rng, n_audios=48, c=c)
        specs, maps = build_bound_maps(
            jnp.asarray(db), jnp.asarray(mask), coefs=coefs
        )
        q = np.concatenate([
            db[None, 3, 20:52, :],  # true-match query
            rng.uniform(-40, 30, size=(1, 32, c)).astype(np.float32),
        ])
        qj, active, use2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        bound = np.asarray(
            bound_votes(specs, maps, qj, active, use2, tolerance)
        )
        _, _, votes_full = match_jax.search_batch(
            db, mask, q, None, coefs=coefs, tolerance=tolerance,
            trunc_coef1=False, aligned=True,
        )
        assert (bound >= np.asarray(votes_full)).all()

    @pytest.mark.parametrize("coefs", [2, 8])
    def test_bound_dominates_with_band_bypass(self, rng, coefs):
        """Bound validity under the freq-ignore band: frames whose q1
        falls outside the band BYPASS the coef-1 tolerance test in the
        matcher (PARITY.md §3.3) and must count as automatic hits in the
        bound — a lattice-only count here once under-stated the true
        aligned score and could certify a wrong winner."""
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import build_bound_maps, bound_votes

        c = max(coefs, 2)
        db, mask = self._db(rng, n_audios=48, c=c)
        specs, maps = build_bound_maps(
            jnp.asarray(db), jnp.asarray(mask), coefs=coefs
        )
        q = np.concatenate([
            db[None, 3, 20:52, :],
            rng.uniform(-40, 30, size=(1, 32, c)).astype(np.float32),
        ])
        # push every q1 out of band -> use2 all-False (full bypass), and a
        # mid-band setting that splits frames between the two regimes
        for lo_hi in ((10, -1), (2, 6)):
            lo, hi = lo_hi
            qj, active, use2 = match_jax.prepare_query(
                q, None, freq_ignore_low=lo, freq_ignore_high=hi,
                trunc_coef1=False,
            )
            bound = np.asarray(
                bound_votes(specs, maps, qj, active, use2, 0.05)
            )
            _, _, votes_full = match_jax.search_batch(
                db, mask, q, None, coefs=coefs, tolerance=0.05,
                freq_ignore_low=lo, freq_ignore_high=hi,
                trunc_coef1=False, aligned=True,
            )
            assert (bound >= np.asarray(votes_full)).all()

    @pytest.mark.parametrize("tolerance", [0.36, 0.5, 1.0])
    def test_bound_dominates_at_saturation_edge(self, rng, tolerance):
        """Bound validity at the uint8 saturation boundary: tol=0.36 puts
        the coef-1 scaled threshold (8*tol+1)*64 ≈ 249 just UNDER the 255
        sentinel (dead/masked rows still excluded); tol=0.5 pushes coef 1
        PAST it while coef 0 (s=4) stays informative — the 2-coef bound
        min()s down to the coef-0 term; tol=1.0 saturates BOTH — every
        row passes every bound, including tombstoned ones, and the bound
        must inflate (de-certify) rather than ever under-state a true
        score."""
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import build_bound_maps, bound_votes

        db, mask = self._db(rng, n_audios=48, c=2)
        specs, maps = build_bound_maps(
            jnp.asarray(db), jnp.asarray(mask), coefs=2
        )
        q = np.concatenate([
            db[None, 3, 20:52, :],
            rng.uniform(-40, 30, size=(1, 32, 2)).astype(np.float32),
        ])
        qj, active, use2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        bound = np.asarray(
            bound_votes(specs, maps, qj, active, use2, tolerance)
        )
        _, _, votes_full = match_jax.search_batch(
            db, mask, q, None, coefs=2, tolerance=tolerance,
            trunc_coef1=False, aligned=True,
        )
        assert (bound >= np.asarray(votes_full)).all()
        if tolerance == 1.0:
            # past BOTH coefs' saturation every frame passes every row's
            # bound: it saturates at the active frame count (useless but
            # VALID), and bound_tol_ok gates the prefilter off
            from tiresias_tpu.ops.match_lattice import bound_tol_ok

            n_active = np.asarray(active).sum(axis=1)
            assert (bound == n_active[:, None]).all()
            assert not bound_tol_ok(specs, tolerance)
        if tolerance == 0.5:
            # coef 1 saturated, coef 0 informative: the min keeps the
            # prefilter useful — bound_tol_ok must NOT gate it off
            from tiresias_tpu.ops.match_lattice import bound_tol_ok

            assert bound_tol_ok(specs, tolerance)

    def test_topk_certificate_matches_full_scan(self, rng):
        """top=3: when certified, every audio reaching the 3rd-best
        rescored score is a candidate with its exact score — the scattered
        votes' top-3 (values AND set) equal the full scan's."""
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import build_bound_maps
        from tiresias_tpu.ops.match_pallas import aligned_prefiltered_votes

        db, mask = self._db(rng, n_audios=64)
        # ranks 1-3: the original and two noisy copies
        for dst in (21, 44):
            db[dst] = db[7] + rng.normal(0, 0.01, db[7].shape).astype(
                np.float32
            )
            mask[dst] = mask[7]
        db = np.where(mask[:, :, None], db, PAD_VALUE).astype(np.float32)
        specs, maps = build_bound_maps(jnp.asarray(db), jnp.asarray(mask))
        q = db[None, 7, 10:42, :].astype(np.float32)
        qj, active, use2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        votes_p, cert = aligned_prefiltered_votes(
            db, maps, qj, active, use2, 0.05, specs=specs, coefs=2, k=16,
            interpret=True, top=3,
        )
        assert np.asarray(cert).all()
        _, _, votes_full = match_jax.search_batch(
            db, mask, q, None, coefs=2, tolerance=0.05, trunc_coef1=False,
            aligned=True,
        )
        vp, vf = np.asarray(votes_p)[0], np.asarray(votes_full)[0]
        top_p = sorted(np.argsort(-vp)[:3].tolist())
        top_f = sorted(np.argsort(-vf)[:3].tolist())
        assert top_p == top_f == [7, 21, 44]
        np.testing.assert_array_equal(vp[top_p], vf[top_f])

    def test_topk_certificate_fails_when_kth_ties_unselected(self, rng):
        """More equal-score audios than the candidate budget: the top-k
        certificate must refuse (an unselected duplicate could belong in
        the listing), even at a top where top-1 would also refuse."""
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import build_bound_maps
        from tiresias_tpu.ops.match_pallas import aligned_prefiltered_votes

        base = rng.uniform(-40, 30, size=(64, 2)).astype(np.float32)
        db = np.broadcast_to(base, (16, 64, 2)).copy()
        mask = np.ones((16, 64), bool)
        specs, maps = build_bound_maps(jnp.asarray(db), jnp.asarray(mask))
        q = base[None, 8:24]
        qj, active, use2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        _, cert = aligned_prefiltered_votes(
            db, maps, qj, active, use2, 0.05, specs=specs, coefs=2, k=4,
            interpret=True, top=3,
        )
        assert not np.asarray(cert).any()

    def test_top_beyond_candidate_budget_raises(self, rng):
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import build_bound_maps
        from tiresias_tpu.ops.match_pallas import aligned_prefiltered_votes

        db, mask = self._db(rng, n_audios=16)
        specs, maps = build_bound_maps(jnp.asarray(db), jnp.asarray(mask))
        q = db[None, 3, 10:42, :].astype(np.float32)
        qj, active, use2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        with pytest.raises(ValueError, match="candidate budget"):
            aligned_prefiltered_votes(
                db, maps, qj, active, use2, 0.05, specs=specs, coefs=2,
                k=4, interpret=True, top=5,
            )

    def test_context_filter_certifies_in_context_winner(self, rng):
        """Context-filtered prefilter (the reference's per-context scan,
        fp_handler.c:308-359): the GLOBAL winner lives in another context,
        so a naive global certificate would pick it; the filtered search
        must select, rescore, and certify the IN-context winner only."""
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import build_bound_maps
        from tiresias_tpu.ops.match_pallas import aligned_prefiltered_votes

        db, mask = self._db(rng, n_audios=64)
        # query = exact excerpt of audio 7 (context 0); audio 9 (context 1)
        # is a noisy copy of 7 — the best IN-context-1 match
        db[9] = db[7] + rng.normal(0, 0.004, db[7].shape).astype(np.float32)
        mask[9] = mask[7]
        db = np.where(mask[:, :, None], db, PAD_VALUE).astype(np.float32)
        ctx_ids = (np.arange(64) % 2).astype(np.int32)
        ctx_ids[7] = 0  # the global winner sits OUTSIDE the filter
        specs, maps = build_bound_maps(jnp.asarray(db), jnp.asarray(mask))
        q = db[None, 7, 10:42, :].astype(np.float32)
        qj, active, use2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        votes_p, cert = aligned_prefiltered_votes(
            db, maps, qj, active, use2, 0.05, specs=specs, coefs=2, k=8,
            interpret=True, ctx_ids=jnp.asarray(ctx_ids), ctx_id=1,
        )
        assert np.asarray(cert).all()
        _, _, votes_full = match_jax.search_batch(
            db, mask, q, None, coefs=2, tolerance=0.05, trunc_coef1=False,
            aligned=True,
        )
        votes_p = np.asarray(votes_p)[0]
        votes_full = np.where(ctx_ids == 1, np.asarray(votes_full)[0], 0)
        # out-of-context rows never scatter a vote; the in-context winner
        # and its count equal the masked full scan's
        assert (votes_p[ctx_ids == 0] == 0).all()
        assert votes_p.argmax() == votes_full.argmax() == 9
        assert votes_p.max() == votes_full.max() > 0

    def test_context_filter_fewer_rows_than_k(self, rng):
        """k exceeds the context's row count: out-of-context rows fill the
        candidate set but must rescore to zero, and the certificate is
        trivially satisfied (every in-context row was rescored exactly)."""
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import build_bound_maps
        from tiresias_tpu.ops.match_pallas import aligned_prefiltered_votes

        db, mask = self._db(rng, n_audios=16)
        ctx_ids = np.zeros(16, np.int32)
        ctx_ids[5] = 1
        ctx_ids[11] = 1  # two rows in context 1, k=8
        specs, maps = build_bound_maps(jnp.asarray(db), jnp.asarray(mask))
        q = db[None, 11, 10:42, :].astype(np.float32)
        qj, active, use2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        votes_p, cert = aligned_prefiltered_votes(
            db, maps, qj, active, use2, 0.05, specs=specs, coefs=2, k=8,
            interpret=True, ctx_ids=jnp.asarray(ctx_ids), ctx_id=1,
        )
        assert np.asarray(cert).all()
        votes_p = np.asarray(votes_p)[0]
        assert (votes_p[ctx_ids == 0] == 0).all()
        assert votes_p.argmax() == 11 and votes_p.max() > 0

    def test_context_filter_composes_with_topk(self, rng):
        """--filter-context --top together: kth comes from the ctx-ZEROED
        candidate scores and the bound mask must precede unselected_max —
        the filtered top-3 must equal the masked full scan's top-3 even
        though the GLOBAL top-1 sits outside the filter."""
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import build_bound_maps
        from tiresias_tpu.ops.match_pallas import aligned_prefiltered_votes

        db, mask = self._db(rng, n_audios=64)
        for dst, sigma in ((9, 0.004), (21, 0.01), (44, 0.02)):
            db[dst] = db[7] + rng.normal(0, sigma, db[7].shape).astype(
                np.float32
            )
            mask[dst] = mask[7]
        db = np.where(mask[:, :, None], db, PAD_VALUE).astype(np.float32)
        ctx_ids = np.zeros(64, np.int32)
        ctx_ids[[9, 21, 44]] = 1  # the exact copy (row 7) stays outside
        specs, maps = build_bound_maps(jnp.asarray(db), jnp.asarray(mask))
        q = db[None, 7, 10:42, :].astype(np.float32)
        qj, active, use2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        votes_p, cert = aligned_prefiltered_votes(
            db, maps, qj, active, use2, 0.05, specs=specs, coefs=2, k=16,
            interpret=True, ctx_ids=jnp.asarray(ctx_ids), ctx_id=1, top=3,
        )
        assert np.asarray(cert).all()
        _, _, votes_full = match_jax.search_batch(
            db, mask, q, None, coefs=2, tolerance=0.05, trunc_coef1=False,
            aligned=True,
        )
        vp = np.asarray(votes_p)[0]
        vf = np.where(ctx_ids == 1, np.asarray(votes_full)[0], 0)
        assert (vp[ctx_ids == 0] == 0).all()
        top_p = sorted(np.argsort(-vp)[:3].tolist())
        assert top_p == [9, 21, 44]
        np.testing.assert_array_equal(vp[top_p], vf[top_p])
        # a context with fewer rows than top certifies trivially: every
        # in-context row is a rescored candidate
        ctx_ids2 = np.zeros(64, np.int32)
        ctx_ids2[[5, 11]] = 2
        votes_s, cert_s = aligned_prefiltered_votes(
            db, maps, qj, active, use2, 0.05, specs=specs, coefs=2, k=8,
            interpret=True, ctx_ids=jnp.asarray(ctx_ids2), ctx_id=2, top=3,
        )
        assert np.asarray(cert_s).all()
        assert (np.asarray(votes_s)[0][ctx_ids2 != 2] == 0).all()

    def test_context_filter_unknown_context_finds_nothing(self, rng):
        """An id no row carries (store.ctx_id_for of an unknown context):
        certified, all zeros → NOTFOUND, not a full-scan fallback."""
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import build_bound_maps
        from tiresias_tpu.ops.match_pallas import aligned_prefiltered_votes

        db, mask = self._db(rng, n_audios=16)
        ctx_ids = np.zeros(16, np.int32)
        specs, maps = build_bound_maps(jnp.asarray(db), jnp.asarray(mask))
        q = db[None, 3, 10:42, :].astype(np.float32)
        qj, active, use2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        votes_p, cert = aligned_prefiltered_votes(
            db, maps, qj, active, use2, 0.05, specs=specs, coefs=2, k=8,
            interpret=True, ctx_ids=jnp.asarray(ctx_ids), ctx_id=7,
        )
        assert np.asarray(cert).all()
        assert (np.asarray(votes_p) == 0).all()


class TestKernelFitGates:
    """The kernels' stated shape rules, the platform choice, and the
    index-array row path — all checked on the CPU."""

    def test_query_fit_budget(self):
        from tiresias_tpu.ops.match_pallas import _query_rows

        q = np.arange(2 * 94 * 2, dtype=np.float32).reshape(2, 94, 2)
        active = np.ones((2, 94), bool)
        active[1, 50:] = False
        rows = np.asarray(_query_rows(q, active, active, 2))
        # powers of two in both kernel-visible dims
        assert rows.shape == (2, 4, 128)
        assert (rows[1, 0, 50:94] == 1e6).all()  # inactive → INACTIVE_Q
        np.testing.assert_array_equal(rows[0, 1, :94], q[0, :, 1])

    def test_aligned_fit_budget(self):
        from tiresias_tpu.ops.match_pallas import (
            MAX_DB_ELEMS,
            aligned_kernel_serves,
        )

        assert aligned_kernel_serves(8, 100_000 * 1024 * 8)  # accuracy mode
        assert aligned_kernel_serves(2, 128 * 131_072 * 2)   # hours-long tier
        assert not aligned_kernel_serves(2, MAX_DB_ELEMS + 1)
        # a tile reshapes to [A_t, O_t, C]: C must be a power of two
        assert not aligned_kernel_serves(3, 1000)
        assert aligned_kernel_serves(1, 1000)

    def test_aligned_time_chunk_selection(self):
        """Offset tiles cover every offset bucket exactly once: the
        kernel's output spans ceil((T + F − 1) / O_t) tiles."""
        import jax

        import tiresias_tpu.ops.match_pallas as mp

        t, f = 384, 70
        n_o = -(-(t + f - 1) // mp.ALIGNED_O_TILE)
        jaxpr = jax.make_jaxpr(
            lambda d, q, a, u: mp._kernel_votes(
                d, q, a, u, np.float32(0.1), None, coefs=2, aligned=True,
                interpret=True,
            )
        )(np.zeros((5, t, 2), np.float32), np.zeros((1, f, 2), np.float32),
          np.ones((1, f), bool), np.ones((1, f), bool))
        assert f"1,{n_o},{mp.ALIGNED_A_TILE}" in str(jaxpr).replace(" ", "")

    def test_bag_fit_budget(self):
        from tiresias_tpu.ops.match_pallas import (
            BAG_TILE_ELEMS,
            MAX_DB_ELEMS,
            bag_kernel_serves,
        )

        assert bag_kernel_serves(128, 102_400 * 128 * 2)  # dialplan store
        assert bag_kernel_serves(BAG_TILE_ELEMS, 10)
        assert bag_kernel_serves(3000, 10)  # pads to 4096
        assert not bag_kernel_serves(BAG_TILE_ELEMS + 1, 10)
        assert not bag_kernel_serves(112_500, 10)  # hour-long audio tier
        assert not bag_kernel_serves(128, MAX_DB_ELEMS + 1)

    def test_oversize_shapes_raise_cleanly(self, rng, caplog):
        """A shape the bag kernel cannot serve runs the XLA form — with a
        warning that names the rule — and stays exact."""
        import logging

        from tiresias_tpu.ops.match_pallas import fused_votes

        db = rng.uniform(-1, 1, size=(3, 8192, 2)).astype(np.float32)
        q = db[1:2, 100:164].copy()
        act = np.ones((1, 64), bool)
        with caplog.at_level(logging.WARNING):
            got = fused_votes(db, q, act, act, 0.1, coefs=2, interpret=True)
        assert "cannot serve" in caplog.text
        want = match_jax.match_votes(
            db, np.ones(db.shape[:2], bool), q, act, act, 0.1, coefs=2
        )
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def test_aligned_non_power_of_two_coefs_run_xla(self, rng, caplog):
        """A 3-coefficient store is refused by the aligned kernel's rule
        and served, exactly, by the XLA form."""
        import logging

        from tiresias_tpu.ops.match_pallas import fused_votes

        db, mask, _ = _random_db(rng, n_audios=6, t=128, c=3)
        q = db[2:3, 10:30].copy()
        qj, act, u2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        with caplog.at_level(logging.WARNING):
            got = fused_votes(db, qj, act, u2, 0.2, coefs=3, aligned=True,
                              interpret=True)
        assert "cannot serve" in caplog.text
        want = match_jax.match_votes(db, mask, qj, act, u2, 0.2, coefs=3,
                                     aligned=True)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def test_aligned_chunked_matches_xla(self, rng):
        """Aligned votes over a tier longer than one offset tile and an
        audio count that is no multiple of the audio tile are
        bit-identical to the XLA aligned matcher."""
        import tiresias_tpu.ops.match_pallas as mp

        db = rng.uniform(-30, 20, size=(5, 256, 2)).astype(np.float32)
        db[2, 200:] = -1e6  # PAD_VALUE rows
        q = np.stack(
            [db[2, 100:124, :], rng.uniform(-30, 20, (24, 2))]
        ).astype(np.float32)
        qj, active, use2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        votes_p = mp.fused_votes(
            db, qj, active, use2, 0.1, coefs=2, aligned=True, interpret=True
        )
        mask = (db[:, :, 0] > -1e5)
        votes_x = match_jax.match_votes(
            db, mask, qj, active, use2, 0.1, coefs=2, aligned=True
        )
        np.testing.assert_array_equal(
            np.asarray(votes_p), np.asarray(votes_x)
        )

    @pytest.mark.parametrize("aligned", [False, True])
    def test_cuda_lowering_runs_the_triton_kernel(self, rng, aligned):
        """The one entry point picks the Triton kernel when the program is
        lowered for the GPU and the XLA form otherwise (no GPU needed to
        lower)."""
        import jax

        from tiresias_tpu.ops.match_pallas import fused_votes

        db = rng.uniform(-30, 20, size=(40, 128, 2)).astype(np.float32)
        q = rng.uniform(-30, 20, size=(2, 20, 2)).astype(np.float32)
        act = np.ones((2, 20), bool)
        fn = jax.jit(lambda d, q, a, u: fused_votes(
            d, q, a, u, 0.1, coefs=2, aligned=aligned))
        traced = fn.trace(db, q, act, act)
        gpu = traced.lower(lowering_platforms=("cuda",)).as_text()
        cpu = traced.lower(lowering_platforms=("cpu",)).as_text()
        assert "xla.gpu.triton" in gpu
        assert "tiresias_" in gpu  # the kernel's stable name
        assert "xla.gpu.triton" not in cpu

    @pytest.mark.parametrize("aligned", [False, True])
    def test_rows_index_array_equals_gathered_rows(self, rng, aligned):
        """The prefilter's rescore path: each query's own rows, read
        through the index array, equal the votes of the gathered rows."""
        from tiresias_tpu.ops.match_pallas import fused_votes

        db, mask, _ = _random_db(rng, n_audios=50, t=128)
        q = rng.uniform(-40, 30, size=(3, 20, 2)).astype(np.float32)
        qj, act, u2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        rows = rng.integers(0, 50, size=(3, 16)).astype(np.int32)
        got = fused_votes(db, qj, act, u2, 2.5, coefs=2, aligned=aligned,
                          rows=rows, interpret=True)
        full = match_jax.match_votes(db, mask, qj, act, u2, 2.5, coefs=2,
                                     aligned=aligned)
        np.testing.assert_array_equal(
            np.asarray(got), np.take_along_axis(np.asarray(full), rows, 1)
        )

    def test_padded_query_frames_never_match_padding(self, rng):
        """A PAD_VALUE query frame with no frame count is inactive in both
        forms — as the masked matcher treats it."""
        from tiresias_tpu.ops.match_pallas import fused_votes

        db, mask, _ = _random_db(rng, n_audios=9, t=128)
        q = rng.uniform(-40, 30, size=(1, 16, 2)).astype(np.float32)
        q[0, 8:] = PAD_VALUE
        qj, act, u2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        want = match_jax.match_votes(db, mask, qj, act, u2, 0.5, coefs=2)
        for interpret in (False, True):
            got = fused_votes(db, qj, act, u2, 0.5, coefs=2,
                              interpret=interpret)
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


class TestPrefilterBandBypass:
    def test_certified_result_equals_full_scan_under_bands(self, rng):
        """End-to-end prefilter correctness in the band-bypass regime:
        whenever the certificate holds, winner and count must equal the
        full aligned scan with the same freq-ignore band."""
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import build_bound_maps
        from tiresias_tpu.ops.match_pallas import aligned_prefiltered_votes

        db = rng.uniform(-40, 30, size=(64, 128, 2)).astype(np.float32)
        mask = np.ones((64, 128), bool)
        specs, maps = build_bound_maps(jnp.asarray(db), jnp.asarray(mask))
        q = np.stack([db[7, 10:42, :], db[31, 40:72, :]]).astype(np.float32)
        for lo, hi in ((2, 6), (1, 300)):
            qj, active, use2 = match_jax.prepare_query(
                q, None, freq_ignore_low=lo, freq_ignore_high=hi,
                trunc_coef1=False,
            )
            votes_p, cert = aligned_prefiltered_votes(
                db, maps, qj, active, use2, 0.05, specs=specs, coefs=2,
                k=8, interpret=True,
            )
            votes_p, cert = np.asarray(votes_p), np.asarray(cert)
            _, _, votes_full = match_jax.search_batch(
                db, mask, q, None, coefs=2, tolerance=0.05,
                freq_ignore_low=lo, freq_ignore_high=hi,
                trunc_coef1=False, aligned=True,
            )
            votes_full = np.asarray(votes_full)
            for b in range(2):
                if cert[b] and votes_full[b].max() > 0:
                    assert votes_p[b].argmax() == votes_full[b].argmax()
                    assert votes_p[b].max() == votes_full[b].max()


class TestBagPrefilter:
    """Certified two-stage STRICT-BAG search (round 5, VERDICT r4 #6):
    the same lattice bound certifies the bag score a fortiori
    (bag <= min-coef bound is the MIDDLE term of the aligned chain);
    stage 2 rescores candidates with the bag kernel. This is the fast
    path for the reference's own strict coefs=2/no-truncation library
    configuration (fp_handler.c:247-250,321)."""

    def _db(self, rng, n_audios, t=128, c=2):
        db = rng.uniform(-40, 30, size=(n_audios, t, c)).astype(np.float32)
        n_frames = rng.integers(96, t + 1, size=n_audios)
        mask = np.arange(t)[None, :] < n_frames[:, None]
        db = np.where(mask[:, :, None], db, PAD_VALUE).astype(np.float32)
        return db, mask

    def test_matches_full_bag_when_certified(self, rng):
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import build_bound_maps
        from tiresias_tpu.ops.match_pallas import aligned_prefiltered_votes

        db, mask = self._db(rng, n_audios=64)
        specs, maps = build_bound_maps(jnp.asarray(db), jnp.asarray(mask))
        q = np.stack([db[7, 10:42, :], db[31, 40:72, :]]).astype(np.float32)
        qj, active, use2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        votes_p, cert = aligned_prefiltered_votes(
            db, maps, qj, active, use2, 0.05, specs=specs, coefs=2, k=8,
            interpret=True, aligned=False,
        )
        assert np.asarray(cert).all()
        _, _, votes_full = match_jax.search_batch(
            db, mask, q, None, coefs=2, tolerance=0.05, trunc_coef1=False,
            aligned=False,
        )
        votes_p, votes_full = np.asarray(votes_p), np.asarray(votes_full)
        for b in range(2):
            assert votes_p[b].argmax() == votes_full[b].argmax()
            assert votes_p[b].max() == votes_full[b].max()

    def test_k_covering_all_matches_bag_scan_exactly(self, rng):
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import build_bound_maps
        from tiresias_tpu.ops.match_pallas import aligned_prefiltered_votes

        db, mask = self._db(rng, n_audios=12)
        specs, maps = build_bound_maps(jnp.asarray(db), jnp.asarray(mask))
        q = rng.uniform(-40, 30, size=(1, 24, 2)).astype(np.float32)
        qj, active, use2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        votes_p, cert = aligned_prefiltered_votes(
            db, maps, qj, active, use2, 1.0, specs=specs, coefs=2, k=64,
            interpret=True, aligned=False,
        )
        assert np.asarray(cert).all()
        _, _, votes_full = match_jax.search_batch(
            db, mask, q, None, coefs=2, tolerance=1.0, trunc_coef1=False,
            aligned=False,
        )
        np.testing.assert_array_equal(
            np.asarray(votes_p), np.asarray(votes_full)
        )

    @pytest.mark.parametrize("coefs", [1, 2, 4])
    def test_bound_dominates_true_bag_score(self, rng, coefs):
        """Soundness of reusing the aligned bound for bag rescoring:
        bound >= bag score for EVERY audio (not just the winner)."""
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import (
            bound_votes,
            build_bound_maps,
        )

        db, mask = self._db(rng, n_audios=24, c=max(2, coefs))
        specs, maps = build_bound_maps(
            jnp.asarray(db), jnp.asarray(mask), coefs
        )
        q = rng.uniform(-40, 30, size=(3, 20, max(2, coefs))).astype(
            np.float32
        )
        qj, active, use2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        for tol in (0.05, 0.3, 1.0):
            bound = np.asarray(
                bound_votes(specs, maps, qj, active, use2, tol)
            )
            _, _, bag = match_jax.search_batch(
                db, mask, q, None, coefs=coefs, tolerance=tol,
                trunc_coef1=False, aligned=False,
            )
            assert (bound >= np.asarray(bag)).all(), (
                f"bound under-states bag votes at tol={tol}"
            )

    def test_engine_strict_config_takes_bag_prefilter(self, tmp_path,
                                                      monkeypatch):
        """The strict coefs=2 search on a mesh engine (the CPU-reachable
        fused path) must dispatch the certified bag prefilter and agree
        with an unsharded full scan."""
        import jax

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        from tiresias_tpu.api import Tiresias
        from tiresias_tpu.config import TiresiasConfig
        from tiresias_tpu.parallel import make_mesh
        from tiresias_tpu.ops import match_pallas as mp

        rng2 = np.random.default_rng(5)
        mesh = make_mesh(4, 2)
        # ONE corpus, added to both engines (per-engine draws would make
        # the oracle compare different databases)
        fps = []
        for i in range(10240):  # >2*PREFILTER_K rows per db shard
            mu = rng2.uniform(-25, 20, (1, 2)).astype(np.float32)
            fps.append(mu + rng2.normal(0, 1.5, (32, 2)).astype(np.float32))
        engines = []
        for sub, m in (("a", mesh), ("b", None)):
            eng = Tiresias(
                TiresiasConfig(data_dir=str(tmp_path / sub)),
                restore=False, mesh=m,
            )
            eng.create_context("c")
            for i, fp in enumerate(fps):
                eng.store.add_audio(f"t{i}", "c", fp, f"h{sub}{i:06d}")
            engines.append(eng)
        meshed, single = engines
        calls = {"n": 0}
        orig = mp.aligned_prefiltered_votes

        def spy(*a, **kw):
            if not kw.get("aligned", True):
                calls["n"] += 1
            return orig(*a, **kw)

        monkeypatch.setattr(mp, "aligned_prefiltered_votes", spy)
        target = meshed.store.get_fingerprint(
            meshed.get_audios("c")[17].uuid
        )
        q = target[4:28] + rng2.normal(0, 0.002, (24, 2)).astype(np.float32)
        # drive _votes_for_view directly (search_pcm is DSP-coupled) and
        # compare against an unsharded full scan
        qj, active, use2 = match_jax.prepare_query(
            q[None], None, trunc_coef1=False
        )
        view_m = meshed.store.search_views()[0]
        votes_m = meshed._votes_for_view(
            view_m, qj, np.array([24]), 2, 0.05, -1, -1, False, False,
            True, False,
        )
        assert calls["n"] >= 1, "strict config never took the bag prefilter"
        view_s = single.store.search_views()[0]
        _, _, votes_s = match_jax.search_batch(
            view_s.db, view_s.mask, q[None], None, coefs=2, tolerance=0.05,
            trunc_coef1=False, aligned=False,
        )
        vm = np.asarray(votes_m)[0, : view_m.n_audios]
        vs = np.asarray(votes_s)[0, : view_s.n_audios]
        assert vm.argmax() == vs.argmax()
        assert vm.max() == vs.max()
        meshed.close()
        single.close()
