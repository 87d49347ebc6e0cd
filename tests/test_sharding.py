"""Multi-device sharding tests on the CPU-simulated 8-device mesh.

Validates that the shard_map DB-sharded search and batch-sharded
fingerprinting produce bit-identical results to the single-device paths —
the SURVEY.md §4.5 strategy for testing multi-chip logic without a cluster.
"""

import jax
import numpy as np
import pytest

from tiresias_tpu.ops import match_jax
from tiresias_tpu.ops.mfcc_jax import (
    PAD_VALUE,
    fingerprint_padded_batch,
    pad_frames_bucket,
)
from tiresias_tpu.parallel import (
    make_mesh,
    shard_db,
    sharded_fingerprint,
    sharded_search,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def _random_db(rng, n_audios=37, t=96, c=2):
    db = rng.uniform(-30, 25, size=(n_audios, t, c)).astype(np.float32)
    n_frames = rng.integers(8, t, size=n_audios)
    mask = np.arange(t)[None, :] < n_frames[:, None]
    db = np.where(mask[:, :, None], db, PAD_VALUE).astype(np.float32)
    return db, mask


def _random_query(rng, b=5, f=48, c=2):
    q = rng.uniform(-30, 25, size=(b, f, c)).astype(np.float32)
    n_frames = rng.integers(4, f, size=b).astype(np.int32)
    return q, n_frames


class TestShardedSearch:
    @pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
    def test_matches_single_device(self, rng, mesh_shape):
        mesh = make_mesh(*mesh_shape)
        db, mask = _random_db(rng)
        q, n_frames = _random_query(rng, b=8)
        db_s, mask_s, n_audios = shard_db(mesh, db, mask)

        best_s, count_s, votes_s = sharded_search(
            mesh, db_s, mask_s, q, n_frames,
            coefs=2, tolerance=1.0, n_audios=n_audios,
        )
        best_1, count_1, votes_1 = match_jax.search_batch(
            db, mask, q, n_frames, coefs=2, tolerance=1.0
        )
        np.testing.assert_array_equal(np.asarray(votes_s), np.asarray(votes_1))
        np.testing.assert_array_equal(np.asarray(best_s), np.asarray(best_1))
        np.testing.assert_array_equal(np.asarray(count_s), np.asarray(count_1))

    def test_uneven_batch_padded(self, rng):
        mesh = make_mesh(2, 4)
        db, mask = _random_db(rng, n_audios=10)
        q, n_frames = _random_query(rng, b=3)  # 3 not divisible by 4
        db_s, mask_s, n_audios = shard_db(mesh, db, mask)
        best_s, count_s, votes_s = sharded_search(
            mesh, db_s, mask_s, q, n_frames, coefs=1, tolerance=0.5,
            n_audios=n_audios,
        )
        best_1, count_1, votes_1 = match_jax.search_batch(
            db, mask, q, n_frames, coefs=1, tolerance=0.5
        )
        np.testing.assert_array_equal(np.asarray(votes_s), np.asarray(votes_1))
        np.testing.assert_array_equal(np.asarray(best_s), np.asarray(best_1))

    def test_band_filter_and_trunc_modes(self, rng):
        mesh = make_mesh(4, 2)
        db, mask = _random_db(rng, n_audios=9)
        q, n_frames = _random_query(rng, b=4)
        db_s, mask_s, n_audios = shard_db(mesh, db, mask)
        for trunc in (True, False):
            kw = dict(
                coefs=2, tolerance=0.8, freq_ignore_low=30,
                freq_ignore_high=250, trunc_coef1=trunc,
            )
            _, _, votes_s = sharded_search(
                mesh, db_s, mask_s, q, n_frames, n_audios=n_audios, **kw
            )
            _, _, votes_1 = match_jax.search_batch(db, mask, q, n_frames, **kw)
            np.testing.assert_array_equal(np.asarray(votes_s), np.asarray(votes_1))


class TestShardedPallasMatcher:
    def test_matches_xla_matcher(self, rng):
        """Per-shard Triton matcher (interpret mode on the CPU mesh) must
        equal the single-device XLA matcher."""
        from tiresias_tpu.parallel.sharding import sharded_votes_pallas

        mesh = make_mesh(4, 2)
        db, mask = _random_db(rng, n_audios=32, t=128)  # 32 % 4 == 0
        q, n_frames = _random_query(rng, b=4)
        qp, active, use2 = match_jax.prepare_query(q, n_frames)
        votes_p = sharded_votes_pallas(
            mesh, db, qp, active, use2, 0.9, coefs=2, interpret=True
        )
        votes_x = match_jax.match_votes(
            db, mask, qp, active, use2, 0.9, coefs=2
        )
        np.testing.assert_array_equal(np.asarray(votes_p), np.asarray(votes_x))

    def test_aligned_matches_xla_matcher(self, rng):
        """ALIGNED (offset-consistent, PARITY D9) fused matcher per DB
        shard: per-audio offset maxima commute with db-sharding, so the
        shard_map result must equal the single-device XLA aligned matcher
        bitwise."""
        from tiresias_tpu.parallel.sharding import sharded_votes_pallas

        mesh = make_mesh(4, 2)
        db, mask = _random_db(rng, n_audios=32, t=128)
        q, n_frames = _random_query(rng, b=4)
        qp, active, use2 = match_jax.prepare_query(q, n_frames)
        votes_p = sharded_votes_pallas(
            mesh, db, qp, active, use2, 0.9, coefs=2, aligned=True,
            interpret=True,
        )
        votes_x = match_jax.match_votes(
            db, mask, qp, active, use2, 0.9, coefs=2, aligned=True
        )
        np.testing.assert_array_equal(np.asarray(votes_p), np.asarray(votes_x))

    @pytest.mark.parametrize("aligned", [False, True])
    def test_sharded_search_use_pallas(self, rng, aligned):
        """sharded_search(use_pallas=True) — the engine's sharded fused
        dispatch — with uneven batch and non-divisible audio counts (the
        shard_db padding rows hold PAD_VALUE so the value-encoded kernels
        never count them)."""
        mesh = make_mesh(4, 2)
        db, mask = _random_db(rng, n_audios=30, t=128)  # pads 30 -> 32
        q, n_frames = _random_query(rng, b=3)  # pads 3 -> 4 queries
        db_s, mask_s, n_audios = shard_db(mesh, db, mask)
        best_p, count_p, votes_p = sharded_search(
            mesh, db_s, mask_s, q, n_frames, coefs=2, tolerance=0.9,
            trunc_coef1=False, aligned=aligned, n_audios=n_audios,
            use_pallas=True, interpret=True,
        )
        best_x, count_x, votes_x = match_jax.search_batch(
            db, mask, q, n_frames, coefs=2, tolerance=0.9,
            trunc_coef1=False, aligned=aligned,
        )
        np.testing.assert_array_equal(np.asarray(votes_p), np.asarray(votes_x))
        np.testing.assert_array_equal(np.asarray(best_p), np.asarray(best_x))
        np.testing.assert_array_equal(np.asarray(count_p), np.asarray(count_x))


class TestShardedPrefilter:
    """Certified two-stage aligned search per DB shard: every shard
    certifies its own rows; disjoint vote columns compose exactly."""

    def _clustered_db(self, n_audios=64, t=128, c=2):
        # per-audio clustered values so bounds are selective (uniform
        # noise would make every audio hit every bound). LOCAL rng, not
        # the session fixture: the certification assertions below are
        # data-marginal (a shard with more than k weak-bound rows
        # legitimately de-certifies), so the corpus must not depend on
        # how much rng state earlier tests consumed. Seed 1 gives every
        # shard >= 3 rows of candidate headroom under k=8.
        rng = np.random.default_rng(1)
        mu = rng.uniform(-25, 20, size=(n_audios, 1, c)).astype(np.float32)
        db = (mu + rng.normal(0, 1.5, (n_audios, t, c))).astype(np.float32)
        n_frames = rng.integers(96, t + 1, size=n_audios)
        mask = np.arange(t)[None, :] < n_frames[:, None]
        db = np.where(mask[:, :, None], db, PAD_VALUE).astype(np.float32)
        return db, mask

    def test_matches_full_scan_when_certified(self):
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import build_bound_maps
        from tiresias_tpu.parallel.sharding import (
            sharded_aligned_prefiltered,
        )

        mesh = make_mesh(4, 2)
        db, mask = self._clustered_db()  # 64 % 4 == 0
        specs, maps = build_bound_maps(jnp.asarray(db), jnp.asarray(mask))
        q = np.stack([db[7, 10:42], db[33, 40:72]]).astype(np.float32)
        qp, active, use2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        votes_p, certs = sharded_aligned_prefiltered(
            mesh, db, maps, qp, active, use2, 0.05, specs, 2,
            interpret=True, k=8,  # 8 of 16 rows per shard: real selection
        )
        certs = np.asarray(certs)
        assert certs.shape == (2, 4) and certs.all()
        _, _, votes_full = match_jax.search_batch(
            db, mask, q, None, coefs=2, tolerance=0.05, trunc_coef1=False,
            aligned=True,
        )
        vp, vf = np.asarray(votes_p), np.asarray(votes_full)
        for b, target in ((0, 7), (1, 33)):
            assert vp[b].argmax() == vf[b].argmax() == target
            assert vp[b].max() == vf[b].max() == 32
            # non-candidates may be zeroed but never beat the winner
            assert (vp[b] <= vf[b]).all()

    def test_any_shard_failure_visible(self):
        """A shard full of duplicates fails ITS certificate column while
        clean shards still certify — the caller's certs.all() gate must
        see the failure."""
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import build_bound_maps
        from tiresias_tpu.parallel.sharding import (
            sharded_aligned_prefiltered,
        )

        mesh = make_mesh(4, 2)
        db, mask = self._clustered_db()
        # shard 1 (rows 16..31): all identical -> its k-th bound ties
        db[16:32] = db[16]
        mask[16:32] = mask[16]
        specs, maps = build_bound_maps(jnp.asarray(db), jnp.asarray(mask))
        q = np.stack([db[16, 10:42], db[16, 10:42]]).astype(np.float32)
        qp, active, use2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        _, certs = sharded_aligned_prefiltered(
            mesh, db, maps, qp, active, use2, 0.05, specs, 2,
            interpret=True, k=4,
        )
        certs = np.asarray(certs)
        assert not certs[:, 1].any()  # the duplicate shard refuses
        assert not certs.all()  # ...so the caller's gate must full-scan
        # at least one clean shard still certifies independently (a shard
        # with no match and loose bounds may legitimately refuse too)
        assert certs.any(axis=1).all()

    def test_context_filter_across_shards(self):
        """ctx keep key under shard_map: the global winner lives in an
        out-of-filter context on another shard; the filtered search must
        certify and return the in-context winner."""
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import build_bound_maps
        from tiresias_tpu.parallel.sharding import (
            sharded_aligned_prefiltered,
        )

        mesh = make_mesh(4, 2)
        db, mask = self._clustered_db()
        # noisy copy of row 7 (shard 0) lives at row 40 (shard 2)
        db[40] = db[7] + np.random.default_rng(2).normal(
            0, 0.004, db[7].shape
        ).astype(np.float32)
        mask[40] = mask[7]
        db = np.where(mask[:, :, None], db, PAD_VALUE).astype(np.float32)
        ctx_ids = np.zeros(64, np.int32)
        ctx_ids[32:] = 1  # shards 2-3 are context 1
        specs, maps = build_bound_maps(jnp.asarray(db), jnp.asarray(mask))
        q = np.stack([db[7, 10:42], db[7, 10:42]]).astype(np.float32)
        qp, active, use2 = match_jax.prepare_query(q, None, trunc_coef1=False)
        votes_p, certs = sharded_aligned_prefiltered(
            mesh, db, maps, qp, active, use2, 0.05, specs, 2,
            interpret=True, k=8, ctx_ids=jnp.asarray(ctx_ids), ctx_id=1,
        )
        assert np.asarray(certs).all()
        vp = np.asarray(votes_p)[0]
        assert (vp[:32] == 0).all()
        assert vp.argmax() == 40 and vp.max() > 0


class TestSequenceParallel:
    def test_long_signal_matches_single_device(self, rng, dsp):
        """One long signal sharded on the frame axis with a 256-sample
        ppermute halo must reproduce the single-device fingerprint exactly
        (the halo replaces frames_from_pcm's zero initial buffer at shard
        boundaries)."""
        from tiresias_tpu.ops.mfcc_jax import fingerprint_signal
        from tiresias_tpu.parallel.sharding import sharded_fingerprint_long

        sr = 8000
        n_dev = 8
        # 2 minutes of audio, divisible by hop*devices
        s = (2 * 60 * sr) // (dsp.hop_size * n_dev) * (dsp.hop_size * n_dev)
        pcm = (0.3 * rng.standard_normal(s)).astype(np.float32)
        mesh = make_mesh(4, 2)
        got = np.asarray(sharded_fingerprint_long(mesh, pcm, sr, dsp))
        ref = fingerprint_signal(pcm, sr, dsp)
        assert got.shape[0] == s // dsp.hop_size
        np.testing.assert_allclose(got, ref[: got.shape[0]], atol=1e-4)

    def test_rejects_undivisible_length(self, dsp):
        from tiresias_tpu.parallel.sharding import sharded_fingerprint_long

        mesh = make_mesh(8, 1)
        with pytest.raises(ValueError):
            sharded_fingerprint_long(
                mesh, np.zeros(dsp.hop_size * 8 + 1, np.float32), 8000, dsp
            )


class TestShardedFingerprint:
    def test_matches_single_device(self, rng, dsp):
        sr = 8000
        pcms = [
            (0.5 * rng.standard_normal(sr // 2 + 77 * i)).astype(np.float32)
            for i in range(8)
        ]
        padded, n_frames = pad_frames_bucket(pcms, dsp.hop_size)
        mesh = make_mesh(4, 2)
        fp_sharded = np.asarray(sharded_fingerprint(mesh, padded, sr, dsp))
        fp_single = np.asarray(fingerprint_padded_batch(padded, sr, dsp))
        np.testing.assert_allclose(fp_sharded, fp_single, atol=1e-5)

    def test_int16_wire_matches_single_device(self, rng, dsp):
        """int16 batches must scale on device exactly like the
        single-device path (a bare f32 cast fed the DSP 32768x-scaled
        samples — caught by the round-5 sharded-ingest dryrun)."""
        sr = 8000
        pcms = [
            np.clip(
                np.round(0.5 * rng.standard_normal(sr // 2) * 32768.0),
                -32768, 32767,
            ).astype(np.int16)
            for _ in range(8)
        ]
        padded, _ = pad_frames_bucket(pcms, dsp.hop_size)
        assert padded.dtype == np.int16
        mesh = make_mesh(4, 2)
        fp_sharded = np.asarray(sharded_fingerprint(mesh, padded, sr, dsp))
        fp_single = np.asarray(fingerprint_padded_batch(padded, sr, dsp))
        np.testing.assert_allclose(fp_sharded, fp_single, atol=1e-5)


class TestShardedIngest:
    def test_sync_over_mesh_matches_unsharded(self, tmp_path, rng):
        """A mesh engine's directory sync fingerprints batches
        data-parallel over the mesh (engine/sync.py dispatch with
        mesh=...); the stored fingerprints must match an unsharded
        engine's for the same corpus, and a checkpoint round-trip under
        the mesh must restore them identically."""
        from tiresias_tpu.api import Tiresias
        from tiresias_tpu.config import ContextConfig, TiresiasConfig
        from tiresias_tpu.utils.audio import synth_tone, write_wav

        sr = 8000
        media = tmp_path / "media"
        media.mkdir()
        for i in range(6):  # not a multiple of 8: exercises batch padding
            write_wav(
                str(media / f"m{i}.wav"),
                synth_tone(200 + 40 * i, 0.7, sr), sr,
            )
        mesh = make_mesh(4, 2)
        cfg_m = TiresiasConfig(
            contexts=(ContextConfig("m", str(media)),),
            data_dir=str(tmp_path / "dm"),
        )
        eng_m = Tiresias(cfg_m, restore=False, mesh=mesh)
        assert eng_m._ingest_mesh() is mesh
        assert eng_m.sync().created == 6
        cfg_s = TiresiasConfig(
            contexts=(ContextConfig("m", str(media)),),
            data_dir=str(tmp_path / "ds"),
        )
        eng_s = Tiresias(cfg_s, restore=False, mesh=None)
        assert eng_s.sync().created == 6
        by_name_m = {e.name: e for e in eng_m.get_audios("m")}
        by_name_s = {e.name: e for e in eng_s.get_audios("m")}
        assert by_name_m.keys() == by_name_s.keys()
        for name, e in by_name_s.items():
            np.testing.assert_allclose(
                eng_m.store.get_fingerprint(by_name_m[name].uuid),
                eng_s.store.get_fingerprint(e.uuid), atol=1e-5,
            )
        fps_m = {
            e.name: eng_m.store.get_fingerprint(e.uuid)
            for e in by_name_m.values()
        }
        eng_m.save()
        eng_m.close()
        eng_s.close()
        eng_r = Tiresias(cfg_m, mesh=mesh)  # restore under the mesh
        by_name_r = {e.name: e for e in eng_r.get_audios("m")}
        assert by_name_r.keys() == by_name_m.keys()
        for name, fp in fps_m.items():
            np.testing.assert_array_equal(
                eng_r.store.get_fingerprint(by_name_r[name].uuid), fp
            )
        eng_r.close()

    def test_multiprocess_mesh_ingests_locally(self, tmp_path, monkeypatch):
        """A mesh containing non-addressable devices (multi-controller)
        must NOT take the sharded ingest path — host-local inputs cannot
        form global arrays."""
        from tiresias_tpu.api import Tiresias
        from tiresias_tpu.config import TiresiasConfig

        mesh = make_mesh(4, 2)
        eng = Tiresias(
            TiresiasConfig(data_dir=str(tmp_path)), restore=False, mesh=mesh
        )
        try:
            import jax

            monkeypatch.setattr(
                jax, "process_index", lambda *a, **k: 7
            )  # every mesh device now looks remote
            assert eng._ingest_mesh() is None
        finally:
            eng.close()


class TestShardingReviewFixes:
    def test_negative_tolerance_uses_default(self, rng):
        """-1 is the reference's 'use default' sentinel in every sibling
        entry point; sharded_search must honor it too instead of silently
        matching nothing (|q-d| <= -1 never holds)."""
        from tiresias_tpu.config import DEF_SEARCH_TOLERANCE

        db, mask = _random_db(rng)
        mesh = make_mesh(4, 2)
        db_s, mask_s, a = shard_db(mesh, db, mask)
        q = rng.uniform(-30, 20, (2, 16, 2)).astype(np.float32)
        _, _, v_neg = sharded_search(
            mesh, db_s, mask_s, q, coefs=2, tolerance=-1.0, n_audios=a
        )
        _, _, v_def = sharded_search(
            mesh, db_s, mask_s, q, coefs=2,
            tolerance=DEF_SEARCH_TOLERANCE, n_audios=a,
        )
        np.testing.assert_array_equal(np.asarray(v_neg), np.asarray(v_def))

    def test_with_top1_false_returns_same_votes(self, rng):
        db, mask = _random_db(rng)
        mesh = make_mesh(4, 2)
        db_s, mask_s, a = shard_db(mesh, db, mask)
        q = rng.uniform(-30, 20, (2, 16, 2)).astype(np.float32)
        best, count, votes = sharded_search(
            mesh, db_s, mask_s, q, coefs=2, tolerance=1.0, n_audios=a
        )
        b2, c2, votes2 = sharded_search(
            mesh, db_s, mask_s, q, coefs=2, tolerance=1.0, n_audios=a,
            with_top1=False,
        )
        assert b2 is None and c2 is None
        np.testing.assert_array_equal(np.asarray(votes), np.asarray(votes2))

    def test_long_signal_shorter_than_overlap_rejected(self, dsp):
        """A per-shard slice shorter than the window overlap would silently
        truncate the halo; the precondition must be a clear ValueError."""
        from tiresias_tpu.parallel.sharding import sharded_fingerprint_long

        mesh = make_mesh(8, 1)
        # at the default dsp (buf 512, hop 256) a minimal divisible signal
        # is still legal (256/shard == overlap 256); a wider window makes
        # the per-shard slice (256) smaller than its overlap (768)
        from tiresias_tpu.config import DspConfig

        wide = DspConfig(buf_size=1024, hop_size=256)
        s = wide.hop_size * 8  # 256 per shard < overlap 768
        with pytest.raises(ValueError, match="overlap"):
            sharded_fingerprint_long(
                mesh, np.zeros(s, np.float32), 8000, wide
            )


class TestShardedLatticePrefilter:
    """Certified DIALPLAN prefilter per DB shard (PARITY D19): uint8
    bound scan + exact rescore on each chip's slice of the distance-map
    rows; disjoint vote columns compose exactly."""

    def _maps(self, db0, mask):
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import (
            build_value_map,
            quantize_value_map,
        )

        vm = build_value_map(jnp.asarray(db0), jnp.asarray(mask))
        return vm, quantize_value_map(vm)

    def _clustered(self, n_audios=64, t=128):
        # local rng for the same reason as TestShardedPrefilter
        rng = np.random.default_rng(6)
        mu = rng.uniform(-25, 20, size=(n_audios, 1)).astype(np.float32)
        db0 = (mu + rng.normal(0, 1.5, (n_audios, t))).astype(np.float32)
        n_frames = rng.integers(96, t + 1, size=n_audios)
        mask = np.arange(t)[None, :] < n_frames[:, None]
        db0 = np.where(mask, db0, PAD_VALUE).astype(np.float32)
        return db0, mask

    def test_matches_full_scan_when_certified(self):
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import lattice_votes
        from tiresias_tpu.parallel.sharding import (
            sharded_lattice_prefiltered,
        )

        mesh = make_mesh(4, 2)
        db0, mask = self._clustered()
        vm, vmq = self._maps(db0, mask)
        q0 = np.stack([db0[7, 10:42], db0[33, 40:72]]).astype(np.float32)
        active = np.ones((2, 32), bool)
        votes_p, certs = sharded_lattice_prefiltered(
            mesh, vm, vmq, jnp.asarray(q0), jnp.asarray(active),
            0.5, -np.inf, np.inf, k=8,  # 8 of 16 rows/shard: real selection
        )
        certs = np.asarray(certs)
        assert certs.shape == (2, 4) and certs.all()
        full = np.asarray(
            lattice_votes(vm, jnp.asarray(q0), jnp.asarray(active), 0.5,
                          -np.inf, np.inf)
        )
        vp = np.asarray(votes_p)
        assert (vp <= full).all()
        for b in range(2):
            # parity with the GSPMD full scan is the contract; the true
            # winner under 1-coef truncated voting need not be the query's
            # source row (the reference's own discrimination limit)
            assert full[b].max() > 0
            assert vp[b].argmax() == full[b].argmax()
            assert vp[b].max() == full[b].max()

    def test_context_filter_across_shards(self):
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import lattice_votes
        from tiresias_tpu.parallel.sharding import (
            sharded_lattice_prefiltered,
        )

        mesh = make_mesh(4, 2)
        db0, mask = self._clustered()
        ctx = np.zeros(64, np.int32)
        ctx[32:] = 1  # shards 2-3 are context 1
        vm, vmq = self._maps(db0, mask)
        q0 = np.stack([db0[40, 10:42], db0[40, 10:42]]).astype(np.float32)
        active = np.ones((2, 32), bool)
        votes_p, certs = sharded_lattice_prefiltered(
            mesh, vm, vmq, jnp.asarray(q0), jnp.asarray(active),
            0.5, -np.inf, np.inf, k=8,
            ctx_ids=jnp.asarray(ctx), ctx_id=1,
        )
        assert np.asarray(certs).all()
        vp = np.asarray(votes_p)[0]
        full = np.asarray(
            lattice_votes(vm, jnp.asarray(q0), jnp.asarray(active), 0.5,
                          -np.inf, np.inf)
        )[0]
        full = np.where(ctx == 1, full, 0)
        assert (vp[:32] == 0).all()
        assert full.max() > 0
        assert vp.argmax() == full.argmax()
        assert vp.max() == full.max()
