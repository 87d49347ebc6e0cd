"""FingerprintStore: CRUD semantics, capacity growth, checkpoint round-trip.

Behavioral model: the reference's audio_list/context_list/audio_fingerprint
tables and their CRUD (/root/reference/src/fp_handler.c:115-197,479-575,
912-1095) plus the backup/restore pair (/root/reference/src/db_ctx_handler.c:
673-717,750-772).
"""

import numpy as np
import pytest

from tiresias_tpu.ops.mfcc_jax import PAD_VALUE
from tiresias_tpu.store import FingerprintStore


def _fp(n_frames: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-40, 25, size=(n_frames, 2)).astype(np.float32)


@pytest.fixture()
def store() -> FingerprintStore:
    s = FingerprintStore(n_coefs=2)
    s.create_context("ctx", "/tmp/ctx")
    return s


class TestContextCrud:
    def test_create_and_list(self, store):
        store.create_context("other", "/tmp/other")
        names = {c["name"] for c in store.get_contexts_all()}
        assert names == {"ctx", "other"}
        assert store.get_context("ctx") == {"name": "ctx", "directory": "/tmp/ctx"}
        assert store.get_context("nope") is None

    def test_delete_context_removes_audios(self, store):
        # fp_delete_context_list_info deletes each audio first
        # (/root/reference/src/fp_handler.c:1039-1095)
        store.add_audio("a.wav", "ctx", _fp(10), "h1")
        store.add_audio("b.wav", "ctx", _fp(12), "h2")
        assert store.delete_context("ctx")
        assert len(store) == 0
        assert store.get_context("ctx") is None
        assert not store.delete_context("ctx")


class TestAudioCrud:
    def test_add_and_get(self, store):
        fp = _fp(10)
        entry = store.add_audio("a.wav", "ctx", fp, "hash-a")
        assert entry is not None and entry.n_frames == 10
        got = store.get_fingerprint(entry.uuid)
        np.testing.assert_array_equal(got, fp)
        assert store.get_audio(entry.uuid).name == "a.wav"

    def test_dedupe_by_context_and_hash(self, store):
        # create_audio_list_info dedupe (/root/reference/src/fp_handler.c:494-507)
        store.create_context("ctx2")
        assert store.add_audio("a.wav", "ctx", _fp(5), "same") is not None
        assert store.add_audio("b.wav", "ctx", _fp(5), "same") is None
        # same hash in a different context is a separate audio
        assert store.add_audio("a.wav", "ctx2", _fp(5), "same") is not None

    def test_unknown_context_rejected(self, store):
        with pytest.raises(KeyError):
            store.add_audio("a.wav", "nope", _fp(5), "h")

    def test_delete_compacts_rows(self, store):
        e1 = store.add_audio("a.wav", "ctx", _fp(5, 1), "h1")
        e2 = store.add_audio("b.wav", "ctx", _fp(7, 2), "h2")
        e3 = store.add_audio("c.wav", "ctx", _fp(9, 3), "h3")
        assert store.delete_audio(e2.uuid)
        assert not store.delete_audio(e2.uuid)
        assert [e.uuid for e in store.iter_entries()] == [e1.uuid, e3.uuid]
        db, mask = store.host_db()
        assert db.shape[0] == 2
        np.testing.assert_array_equal(db[1, :9], _fp(9, 3))
        assert mask[1, :9].all() and not mask[1, 9:].any()

    def test_padding_is_pad_value(self, store):
        store.add_audio("a.wav", "ctx", _fp(5), "h1")
        db, mask = store.host_db()
        assert (db[0, 5:] == PAD_VALUE).all()


class TestCapacityAndDeviceView:
    def test_growth_preserves_data(self, store):
        fps = [_fp(3 + 17 * i, seed=i) for i in range(10)]
        entries = [
            store.add_audio(f"{i}.wav", "ctx", fps[i], f"h{i}") for i in range(10)
        ]
        for i, e in enumerate(entries):
            np.testing.assert_array_equal(store.get_fingerprint(e.uuid), fps[i])

    def test_device_db_bucketed_and_cached(self, store):
        store.add_audio("a.wav", "ctx", _fp(5), "h1")
        db, mask, n = store.device_db()
        assert n == 1 and db.shape[0] % 128 == 0 and db.shape[0] >= 128
        db2, _, _ = store.device_db()
        assert db2 is db  # cached
        store.add_audio("b.wav", "ctx", _fp(5, 2), "h2")
        db3, _, n3 = store.device_db()
        assert db3 is not db and n3 == 2

    def test_context_filter(self, store):
        store.create_context("ctx2")
        store.add_audio("a.wav", "ctx", _fp(5), "h1")
        store.add_audio("b.wav", "ctx2", _fp(5), "h2")
        flt = store.context_filter("ctx2")
        assert flt.shape[0] >= 2 and not flt[0] and flt[1] and not flt[2:].any()
        assert store.context_filter(None) is None


class TestCheckpoint:
    def test_round_trip(self, store, tmp_path):
        fps = [_fp(10 + i, seed=i) for i in range(4)]
        for i in range(4):
            store.add_audio(f"{i}.wav", "ctx", fps[i], f"h{i}")
        store.save(str(tmp_path))
        loaded = FingerprintStore.load(str(tmp_path), n_coefs=2)
        assert len(loaded) == 4
        assert loaded.contexts == {"ctx": "/tmp/ctx"}
        for i, e in enumerate(loaded.iter_entries()):
            np.testing.assert_array_equal(loaded.get_fingerprint(e.uuid), fps[i])

    def test_load_missing_is_empty(self, tmp_path):
        s = FingerprintStore.load(str(tmp_path / "nope"))
        assert len(s) == 0 and s.get_contexts_all() == []

    def test_coef_mismatch_rejected(self, store, tmp_path):
        store.add_audio("a.wav", "ctx", _fp(5), "h")
        store.save(str(tmp_path))
        with pytest.raises(ValueError):
            FingerprintStore.load(str(tmp_path), n_coefs=3)

    def test_generation_rotation_and_fallback(self, store, tmp_path):
        # gen 1: one audio; gen 2: two audios
        store.add_audio("a.wav", "ctx", _fp(5), "h1")
        store.save(str(tmp_path))
        store.add_audio("b.wav", "ctx", _fp(6), "h2")
        store.save(str(tmp_path))
        assert (tmp_path / "catalog.json.bak").exists()
        # current loads gen 2
        assert len(FingerprintStore.load(str(tmp_path), n_coefs=2)) == 2
        # corrupt the current generation → falls back to gen 1
        (tmp_path / "catalog.json").write_text("{ not json")
        loaded = FingerprintStore.load(str(tmp_path), n_coefs=2)
        assert len(loaded) == 1 and loaded.entries[0].name == "a.wav"
        # corrupt both → refuse to start empty (a silent empty store's
        # next save would rotate + GC the existing segment data away)
        (tmp_path / "catalog.json.bak").write_text("junk")
        from tiresias_tpu.store.fingerprint_store import CheckpointUnreadable

        with pytest.raises(CheckpointUnreadable):
            FingerprintStore.load(str(tmp_path), n_coefs=2)


class TestIncrementalViews:
    """Append-only mutations update device views in place (only new rows
    cross host->device); deletes fall back to a full rebuild. Results must
    be indistinguishable from a rebuilt view."""

    def _store_with(self, n):
        import numpy as np

        rng = np.random.default_rng(17)
        store = FingerprintStore(n_coefs=2)
        store.create_context("c")
        for i in range(n):
            store.add_audio(
                f"a{i}", "c",
                rng.uniform(-30, 20, (8, 2)).astype(np.float32), f"h{i}",
            )
        return store, rng

    def test_append_reuses_buffer_rows(self):
        import numpy as np

        store, rng = self._store_with(5)
        v1 = store.search_views()[0]
        from tiresias_tpu.ops.match_lattice import build_value_map  # noqa: F401
        store.value_map_for(v1)  # force lattice map so the update covers it
        fp = rng.uniform(-30, 20, (8, 2)).astype(np.float32)
        e = store.add_audio("new", "c", fp, "hnew")
        v2 = store.search_views()[0]
        assert v2.n_audios == 6
        # content equals a from-scratch rebuild
        fresh = FingerprintStore(n_coefs=2)
        fresh.create_context("c")
        for entry in store.iter_entries():
            fresh.add_audio(entry.name, "c", store.get_fingerprint(entry.uuid),
                            entry.hash, uuid=entry.uuid)
        v_ref = fresh.search_views()[0]
        np.testing.assert_array_equal(np.asarray(v2.db), np.asarray(v_ref.db))
        np.testing.assert_array_equal(np.asarray(v2.mask), np.asarray(v_ref.mask))
        # the incrementally-updated lattice map matches a fresh build too
        vm_ref = fresh.value_map_for(v_ref)
        np.testing.assert_array_equal(
            np.asarray(v2.value_map), np.asarray(vm_ref)
        )
        assert e.uuid in [x.uuid for x in v2.entries]

    def test_ctx_ids_append_extend_and_delete(self):
        """ctx_ids_for (the context-filtered prefilter's keep key): built
        rows carry their context's dense id, appended rows extend the
        cached device array in place, padding rows stay -1, and deletes
        keep the array (a dead row's votes are already 0)."""
        import numpy as np

        store, rng = self._store_with(3)
        store.create_context("c2")
        v1 = store.search_views()[0]
        ids1 = np.asarray(store.ctx_ids_for(v1))
        cid_c = store.ctx_id_for("c")
        cid_c2 = store.ctx_id_for("c2")
        assert cid_c != cid_c2
        assert (ids1[:3] == cid_c).all() and (ids1[3:] == -1).all()
        # appends in a different context extend the cached array
        fp = rng.uniform(-30, 20, (8, 2)).astype(np.float32)
        store.add_audio("x", "c2", fp, "hx")
        v2 = store.search_views()[0]
        ids2 = np.asarray(store.ctx_ids_for(v2))
        assert list(ids2[:4]) == [cid_c, cid_c, cid_c, cid_c2]
        assert (ids2[4:] == -1).all()
        # matches a from-scratch build on a fresh view
        v2_fresh = object.__new__(type(v2))
        for f in v2.__dataclass_fields__:
            setattr(v2_fresh, f, getattr(v2, f))
        v2_fresh.ctx_dev = None
        np.testing.assert_array_equal(
            ids2, np.asarray(store.ctx_ids_for(v2_fresh))
        )
        # unknown context: the -2 sentinel (no row carries it), WITHOUT
        # growing the id map — client-supplied filter names must not leak
        n_ids = len(store._ctx_ids)
        assert store.ctx_id_for("ghost") == -2
        assert store.ctx_id_for("ghost") not in set(ids2.tolist())
        assert len(store._ctx_ids) == n_ids
        # tombstoning keeps the cached array (dead rows can't vote)
        e0 = next(iter(store.iter_entries()))
        store.delete_audio(e0.uuid)
        v3 = store.search_views()[0]
        np.testing.assert_array_equal(np.asarray(store.ctx_ids_for(v3)), ids2)

    def test_delete_tombstones_in_place(self):
        """A delete must NOT rebuild/re-upload the view buffer (round-3
        incremental-delete contract): the db buffer is reused and only the
        dead row's mask is scattered off."""
        import numpy as np

        store, rng = self._store_with(5)
        v1 = store.search_views()[0]
        store.value_map_for(v1)
        victim = store.get_audios_by_context("c")[1]
        store.delete_audio(victim.uuid)
        # no full rebuild: _device_put (the host->device re-upload) must
        # not run — the delete is an on-device scatter of the old buffers
        def boom(*a, **k):
            raise AssertionError("delete triggered a full view re-upload")

        store._device_put = boom
        v = store.search_views()[0]
        assert v.n_audios == 5  # tombstoned row keeps its slot
        assert v.dead_rows == frozenset({1})
        mask = np.asarray(v.mask)
        assert not mask[1].any()  # dead row fully masked
        assert mask[0].any() and mask[2].any()
        # value-masked too: the fused matchers (no mask operand) see only
        # PAD_VALUE in the dead row
        from tiresias_tpu.ops.mfcc_jax import PAD_VALUE as PV

        assert (np.asarray(v.db)[1] == PV).all()
        # the incrementally-updated lattice map can never match row 1
        vm = np.asarray(v.value_map)
        assert np.isinf(vm[1]).all()
        # live rows still match their fingerprints
        for i, entry in enumerate(v.entries):
            if i == 1:
                continue
            np.testing.assert_array_equal(
                np.asarray(v.db)[i, : entry.n_frames],
                store.get_fingerprint(entry.uuid),
            )

    def test_bound_maps_survive_append_and_delete(self):
        """The aligned-prefilter bound maps get the same incremental
        treatment as value_map: appends build only the new rows, deletes
        scatter +inf — never the full multi-second rebuild."""
        import numpy as np

        store, rng = self._store_with(5)
        v1 = store.search_views()[0]
        specs1, maps1 = store.bound_maps_for(v1, coefs=2)
        # append: maps carried over and extended in place
        fp = rng.uniform(-30, 20, (8, 2)).astype(np.float32)
        store.add_audio("new", "c", fp, "hnew")
        v2 = store.search_views()[0]
        assert v2.bound_maps is not None, "append dropped the bound maps"
        specs2, maps2 = store.bound_maps_for(v2, coefs=2)
        assert specs2 == specs1
        # bitwise-identical to a from-scratch build on the new view
        from tiresias_tpu.ops.match_lattice import build_bound_maps

        specs_ref, maps_ref = build_bound_maps(v2.db, v2.mask, 2)
        assert specs_ref == specs2
        for m_inc, m_ref in zip(maps2, maps_ref):
            np.testing.assert_array_equal(
                np.asarray(m_inc, np.float32), np.asarray(m_ref, np.float32)
            )
        # delete: dead row becomes +inf in every map, no rebuild
        victim = store.get_audios_by_context("c")[1]
        store.delete_audio(victim.uuid)
        store._device_put = lambda *a, **k: (_ for _ in ()).throw(
            AssertionError("delete triggered a full view re-upload")
        )
        v3 = store.search_views()[0]
        assert v3.bound_maps is not None, "delete dropped the bound maps"
        _, maps3 = store.bound_maps_for(v3, coefs=2)
        from tiresias_tpu.ops.match_lattice import BOUND_FAR

        for m in maps3:
            # quantized maps mark dead rows with the saturation sentinel
            # (their +inf — match_lattice.BOUND_FAR)
            assert m.dtype == np.uint8
            assert (np.asarray(m)[1] == BOUND_FAR).all()
            # live rows keep real (non-sentinel) distances
            assert (np.asarray(m)[0] < BOUND_FAR).any()

    def test_compaction_rebuilds_and_stays_correct(self):
        import numpy as np

        store, rng = self._store_with(5)
        store.search_views()
        victim = store.get_audios_by_context("c")[1]
        store.delete_audio(victim.uuid)
        store.compact()  # force tombstone reclamation
        v = store.search_views()[0]
        assert v.n_audios == 4
        assert victim.uuid not in [x.uuid for x in v.entries]
        for i, entry in enumerate(v.entries):
            np.testing.assert_array_equal(
                np.asarray(v.db)[i, : entry.n_frames],
                store.get_fingerprint(entry.uuid),
            )

    def test_tombstoned_audio_never_matches(self):
        """End-to-end: search after a delete must not return the victim on
        ANY matcher path — XLA (mask-masked), lattice (value-map-masked),
        and both fused matchers (VALUE-masked: no mask operand at all)."""
        import numpy as np

        from tiresias_tpu.ops import match_jax
        from tiresias_tpu.ops.match_lattice import search_lattice
        from tiresias_tpu.ops.match_pallas import search_batch_pallas

        store, rng = self._store_with(4)
        victim = store.get_audios_by_context("c")[2]
        query = store.get_fingerprint(victim.uuid)[None]  # exact copy
        store.search_views()
        store.delete_audio(victim.uuid)
        v = store.search_views()[0]
        best, count, votes = match_jax.search_batch(
            v.db, v.mask, query, None, coefs=2, tolerance=0.5,
            trunc_coef1=False,
        )
        assert np.asarray(votes)[0, 2] == 0  # dead row votes nothing
        vm = store.value_map_for(v)
        _, _, lvotes = search_lattice(vm, query, None, tolerance=1.0)
        assert np.asarray(lvotes)[0, 2] == 0
        for aligned in (False, True):
            _, _, pvotes = search_batch_pallas(
                v.db, query, None, coefs=2, tolerance=0.5,
                trunc_coef1=False, aligned=aligned, interpret=True,
            )
            assert np.asarray(pvotes)[0, 2] == 0, f"aligned={aligned}"

    def test_capacity_growth_rebuilds(self):
        store, rng = self._store_with(2)
        v1 = store.search_views()[0]
        import numpy as np

        # push past the 128-row bucket: capacity grows, full rebuild
        for i in range(130):
            store.add_audio(
                f"g{i}", "c",
                rng.uniform(-30, 20, (8, 2)).astype(np.float32), f"hg{i}",
            )
        v2 = store.search_views()[0]
        assert v2.db.shape[0] > v1.db.shape[0]
        assert v2.n_audios == 132


class TestBulkDelete:
    def _fp(self, rng, n):
        return rng.uniform(-40, 20, size=(n, 2)).astype(np.float32)

    def test_delete_audios_matches_per_entry_deletes(self):
        rng = np.random.default_rng(21)
        a = FingerprintStore(n_coefs=2)
        b = FingerprintStore(n_coefs=2)
        for s in (a, b):
            s.create_context("c")
            s.create_context("keep")
        uuids = []
        for i in range(12):
            n = 5 + (i % 3) * 130  # spans two frame tiers
            fp = self._fp(rng, n)
            ctx = "keep" if i % 4 == 0 else "c"
            ea = a.add_audio(f"t{i}", ctx, fp, f"h{i}")
            b.add_audio(f"t{i}", ctx, fp, f"h{i}", uuid=ea.uuid)
            uuids.append(ea.uuid)
        doomed = [u for i, u in enumerate(uuids) if i % 4 != 0 and i % 3 != 2]
        assert a.delete_audios(doomed) == len(doomed)
        for u in doomed:
            assert b.delete_audio(u)
        assert [e.uuid for e in a.entries] == [e.uuid for e in b.entries]
        for e in a.entries:
            np.testing.assert_array_equal(
                a.get_fingerprint(e.uuid), b.get_fingerprint(e.uuid)
            )
        # unknown uuids are a no-op, not an error
        assert a.delete_audios(["nope"]) == 0

    def test_delete_context_bulk_keeps_dup_hash_index(self):
        rng = np.random.default_rng(22)
        store = FingerprintStore(n_coefs=2)
        store.create_context("gone")
        store.create_context("stay")
        fp = self._fp(rng, 8)
        store.add_audio("d1", "gone", fp, "samehash", dedupe=False)
        store.add_audio("d2", "gone", fp, "samehash", dedupe=False)
        kept = store.add_audio("k", "stay", fp, "samehash", dedupe=False)
        assert store.delete_context("gone")
        assert store.get_contexts_all() == [
            {"name": "stay", "directory": ""}
        ]
        # the (stay, samehash) index survives untouched
        assert store.find_by_hash("stay", "samehash") is kept
        assert store.find_by_hash("gone", "samehash") is None
        assert len(store) == 1


class TestValueMapSnapshotIsolation:
    def test_stale_view_builds_from_its_own_buffer(self):
        """A lattice map built for a STALE view (store mutated since the
        snapshot) must describe the view's rows, not the compacted live
        tier — otherwise votes are attributed to the wrong audios."""
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import build_value_map

        rng = np.random.default_rng(23)
        store = FingerprintStore(n_coefs=2)
        store.create_context("c")
        fps = [rng.uniform(-40, 20, size=(6, 2)).astype(np.float32) for _ in range(3)]
        entries = [
            store.add_audio(f"t{i}", "c", fps[i], f"h{i}") for i in range(3)
        ]
        view = store.search_views()[0]
        store.delete_audio(entries[0].uuid)  # compacts live tier rows
        vm = np.asarray(store.value_map_for(view))
        expected = np.asarray(
            build_value_map(jnp.asarray(view.db[..., 0]), jnp.asarray(view.mask))
        )
        np.testing.assert_array_equal(vm, expected)

    def test_bulk_delete_repoints_dup_index_to_live_entry(self):
        """Deleting {d1, d3} of three same-hash duplicates must leave the
        hash index on the LIVE d2 — never on an already-deleted entry."""
        rng = np.random.default_rng(24)
        store = FingerprintStore(n_coefs=2)
        store.create_context("c")
        fp = rng.uniform(-40, 20, size=(8, 2)).astype(np.float32)
        d1 = store.add_audio("d1", "c", fp, "same", dedupe=False)
        d2 = store.add_audio("d2", "c", fp, "same", dedupe=False)
        d3 = store.add_audio("d3", "c", fp, "same", dedupe=False)
        assert store.delete_audios([d1.uuid, d3.uuid]) == 2
        survivor = store.find_by_hash("c", "same")
        assert survivor is d2
        assert store.get_audio(survivor.uuid) is d2
