"""Regression tests for the code-review findings (round-1 review pass).

Each test pins one fixed defect; see the commit message for the full list.
"""

import json
import os

import numpy as np
import pytest

from tiresias_tpu.api import Tiresias
from tiresias_tpu.config import ContextConfig, TiresiasConfig
from tiresias_tpu.ops.mfcc_jax import fingerprint_signals
from tiresias_tpu.store import FingerprintStore
from tiresias_tpu.utils.audio import synth_tone, write_wav

SR = 8000


class TestMixedDtypeScaling:
    def test_int16_in_mixed_batch_is_scaled(self, dsp):
        """Finding 1: int16 signals in a float-fallback batch must get the
        /32768 scaling, bit-identical to a pure-int16 batch."""
        tone = synth_tone(440, 0.5, SR)
        i16 = np.clip(np.round(tone * 32768.0), -32768, 32767).astype(np.int16)
        fp_pure, _ = fingerprint_signals([i16], SR, dsp)
        # mixed batch: same int16 signal + one float signal forces float32
        fp_mixed, _ = fingerprint_signals([i16, tone], SR, dsp)
        np.testing.assert_array_equal(fp_mixed[0], fp_pure[0])


class TestUnreadableDirectory:
    def test_sync_is_noop_not_mass_delete(self, tmp_path):
        """Finding 3: a transiently unreadable directory must not delete the
        context's audios."""
        directory = tmp_path / "c"
        directory.mkdir()
        write_wav(str(directory / "a.wav"), synth_tone(440, 0.5, SR), SR)
        cfg = TiresiasConfig(
            contexts=(ContextConfig("c", str(directory)),),
            data_dir=str(tmp_path / "d"),
        )
        eng = Tiresias(cfg, restore=False)
        assert eng.sync().created == 1
        # simulate the mount disappearing
        import shutil

        shutil.rmtree(directory)
        report = eng.sync()
        assert report.deleted == 0
        assert len(eng.get_audios("c")) == 1  # nothing wiped


class TestTornCheckpoint:
    def test_corrupt_current_falls_back_to_bak(self, tmp_path):
        """Finding 4: a torn/corrupt current generation must fall back to
        .bak, not crash every startup."""
        store = FingerprintStore(n_coefs=2)
        store.create_context("c")
        rng = np.random.default_rng(0)
        store.add_audio("a", "c", rng.uniform(-30, 20, (5, 2)).astype(np.float32), "h1")
        store.save(str(tmp_path))
        store.add_audio("b", "c", rng.uniform(-30, 20, (5, 2)).astype(np.float32), "h2")
        store.save(str(tmp_path))
        # tear the current generation's catalog mid-write
        with open(tmp_path / "catalog.json", "w") as f:
            f.write('{"version": 3, "n_coefs": 2, "entr')
        loaded = FingerprintStore.load(str(tmp_path), n_coefs=2)
        assert len(loaded) == 1  # previous generation
        assert loaded.get_audios_by_context("c")[0].name == "a"

    def test_missing_segment_falls_back(self, tmp_path):
        store = FingerprintStore(n_coefs=2)
        store.create_context("c")
        rng = np.random.default_rng(0)
        store.add_audio("a", "c", rng.uniform(-30, 20, (5, 2)).astype(np.float32), "h1")
        store.save(str(tmp_path))
        store.add_audio("b", "c", rng.uniform(-30, 20, (5, 2)).astype(np.float32), "h2")
        store.save(str(tmp_path))
        import json

        cat = json.load(open(tmp_path / "catalog.json"))
        current_only = {
            s[0] for segs in cat["tiers"].values() for s in segs
        } - {
            s[0]
            for segs in json.load(
                open(tmp_path / "catalog.json.bak")
            )["tiers"].values()
            for s in segs
        }
        for name in current_only:  # destroy the newest generation's data
            os.unlink(tmp_path / name)
        loaded = FingerprintStore.load(str(tmp_path), n_coefs=2)
        assert len(loaded) in (0, 1)  # falls back, never crashes


class TestGpuGuard:
    def test_platform_detection(self, rng):
        """The fused matchers pick their implementation from the platform
        the program is lowered for: the Triton kernel for ``cuda``, the
        XLA form for ``cpu``; the interpreter only when a caller asks."""
        import jax

        from tiresias_tpu.ops.match_pallas import fused_votes

        db = rng.uniform(-30, 20, size=(8, 128, 2)).astype(np.float32)
        q = rng.uniform(-30, 20, size=(1, 12, 2)).astype(np.float32)
        act = np.ones((1, 12), bool)

        def lowered(platform, interpret=False):
            fn = jax.jit(lambda d, q, a: fused_votes(
                d, q, a, a, 0.1, coefs=2, interpret=interpret))
            return fn.trace(db, q, act).lower(
                lowering_platforms=(platform,)).as_text()

        assert "xla.gpu.triton" in lowered("cuda")
        assert "xla.gpu.triton" not in lowered("cpu")
        assert "xla.gpu.triton" not in lowered("cpu", interpret=True)


class TestSecondReviewRound:
    def test_filter_context_with_none_scans_everything(self, tmp_path):
        """Review-2 finding 1: filter_context=True with context=None must
        keep the scan-everything behavior (PARITY.md D7), not zero votes."""
        eng = Tiresias(TiresiasConfig(data_dir=str(tmp_path)), restore=False)
        eng.create_context("c")
        eng.add_audio_pcm("c", "t", synth_tone(440, 1.0, SR), SR)
        r = eng.search_pcm(
            None, synth_tone(440, 1.0, SR), SR, tolerance=1.0,
            filter_context=True,
        )
        assert r.found and r.name == "t"

    def test_tie_break_is_global_insertion_order(self, tmp_path):
        """Review-2 finding 3: equal vote counts resolve by insertion order
        (PARITY.md D5) even when tiers reorder the view."""
        eng = Tiresias(TiresiasConfig(data_dir=str(tmp_path)), restore=False)
        eng.create_context("c")
        fp = np.full((300, 2), 10.0, dtype=np.float32)  # tier 512
        first = eng.store.add_audio("first-long", "c", fp, "h1")
        second = eng.store.add_audio("second-short", "c", fp[:50], "h2")
        # a query matching both equally: every frame votes for both
        q = np.full((8000,), 0.0, np.float32)  # silence → constant values
        r = eng.search_pcm("c", q, SR, tolerance=1e9)  # everything matches
        # tie at full votes; view order puts the short (tier 128) first,
        # but D5 requires the earlier-inserted long audio to win
        assert r.uuid == first.uuid, (r.name, r.match_count)

    def test_ingest_batches_bound_padding(self, tmp_path, monkeypatch):
        """Review-2 finding 2: one long file must not blow up every
        batch's padding. Exercises the LIVE batcher in ingest_files via
        its shared bound predicate (batch_exceeds), not a copy of it."""
        from tiresias_tpu.engine import sync as sync_mod
        from tiresias_tpu.store import FingerprintStore

        # shrink the caps so the test corpus is tiny: ≤4 signals per batch
        # and ≤4 x 1 s of padded samples per batch
        monkeypatch.setattr(sync_mod, "INGEST_BATCH", 4)
        monkeypatch.setattr(sync_mod, "MAX_BATCH_PADDED_SAMPLES", 4 * SR)
        dispatched: list[tuple[int, int]] = []
        real_fingerprint = sync_mod.fingerprint_signals_async

        def spy(pcms, samplerate, dsp, **kw):
            lens = [len(p) for p in pcms if len(p)]
            dispatched.append((len(lens), max(lens)))
            return real_fingerprint(pcms, samplerate, dsp, **kw)

        monkeypatch.setattr(sync_mod, "fingerprint_signals_async", spy)

        directory = tmp_path / "media"
        directory.mkdir()
        for i in range(9):
            write_wav(str(directory / f"s{i}.wav"), synth_tone(300 + 10 * i, 1.0, SR), SR)
        write_wav(str(directory / "long.wav"), synth_tone(220, 4.0, SR), SR)

        store = FingerprintStore()
        store.create_context("c", str(directory))
        report = sync_mod.ingest_files(
            store, "c", [str(p) for p in sorted(directory.iterdir())]
        )
        assert report.created == 10 and report.failed == 0
        for count, longest in dispatched:
            assert count <= 4
            assert count * longest <= 4 * SR, dispatched
        # the long file sits alone in its batch
        assert any(count == 1 and longest == 4 * SR for count, longest in dispatched)

    def test_topk_rejects_unknown_kwargs(self, tmp_path):
        """Review-2 finding 6: typos must raise, not silently default."""
        eng = Tiresias(TiresiasConfig(data_dir=str(tmp_path)), restore=False)
        eng.create_context("c")
        eng.add_audio_pcm("c", "t", synth_tone(440, 0.5, SR), SR)
        with pytest.raises(TypeError):
            eng.search_pcm_topk("c", synth_tone(440, 0.5, SR), SR,
                                tolerence=0.5)  # sic


class TestThirdReviewRound:
    def test_bad_hop_ms_rejected_at_open(self, tmp_path):
        """Review-3 finding 2: invalid hop_ms raises at open (a clean
        per-request error) instead of poisoning every scorer tick."""
        from tiresias_tpu.serve import StreamingRecognizer

        eng = Tiresias(TiresiasConfig(data_dir=str(tmp_path)), restore=False)
        rec = StreamingRecognizer(eng, samplerate=SR)
        with pytest.raises((ValueError, TypeError)):
            rec.open("x", context="c", continuous=True, hop_ms="bogus")
        with pytest.raises(ValueError):
            rec.open("x", context="c", continuous=True, hop_ms=-5)
        # string numerics from JSON coerce fine
        rec.open("ok", context="c", duration_ms="500", hop_ms="250",
                 continuous=True)
        assert rec._channels["ok"].duration_ms == 500

    def test_hop_larger_than_duration_skips(self, tmp_path):
        """Review-3 finding 4: hop > duration tracks skip-debt so window
        spacing is exactly one hop."""
        from tiresias_tpu.serve import StreamingRecognizer

        eng = Tiresias(TiresiasConfig(data_dir=str(tmp_path)), restore=False)
        eng.create_context("c")
        eng.add_audio_pcm("c", "t", synth_tone(440, 1.0, SR), SR)
        rec = StreamingRecognizer(eng, samplerate=SR)
        seen = []
        rec.open("x", context="c", duration_ms=250, continuous=True,
                 hop_ms=1000, on_result=lambda cid, r: seen.append(r))
        # feed 2.25 s total in small frames, scoring eagerly: windows at
        # [0, .25) and [1.0, 1.25) and [2.0, 2.25) → exactly 3 results
        pcm = synth_tone(440, 2.25, SR)
        step = SR // 10
        for off in range(0, len(pcm), step):
            rec.push("x", pcm[off : off + step])
            rec.process_ready()
        assert len(seen) == 3, len(seen)

    def test_nonfinite_query_raises_cleanly(self, tmp_path):
        """Review-3 finding 3: NaN queries are rejected at the shared input
        layer, not fingerprinted into spurious matches."""
        eng = Tiresias(TiresiasConfig(data_dir=str(tmp_path)), restore=False)
        eng.create_context("c")
        eng.add_audio_pcm("c", "t", synth_tone(440, 0.5, SR), SR)
        bad = np.full(SR // 2, np.nan, np.float32)
        with pytest.raises(ValueError, match="non-finite"):
            eng.search_pcm("c", bad, SR)
        with pytest.raises(ValueError, match="non-finite"):
            eng.add_audio_pcm("c", "bad", bad, SR)

    def test_push_drops_nonfinite_frames(self, tmp_path):
        from tiresias_tpu.serve import StreamingRecognizer

        eng = Tiresias(TiresiasConfig(data_dir=str(tmp_path)), restore=False)
        eng.create_context("c")
        eng.add_audio_pcm("c", "t", synth_tone(440, 1.0, SR), SR)
        rec = StreamingRecognizer(eng, samplerate=SR)
        rec.open("x", context="c", duration_ms=500, tolerance=1.0)
        rec.push("x", np.full(SR, np.nan, np.float32))  # dropped
        assert rec.process_ready() == {}  # window never fills from NaNs
        rec.push("x", synth_tone(440, 0.6, SR))
        res = rec.process_ready()
        assert res["x"].status == "FOUND"


class TestViewConsistentAttribution:
    def test_delete_between_search_and_attribution(self, tmp_path):
        """Finding 9: result attribution uses the device view's row order,
        immune to concurrent deletes compacting the live catalog."""
        eng = Tiresias(TiresiasConfig(data_dir=str(tmp_path)), restore=False)
        eng.create_context("c")
        names = []
        for i in range(4):
            e = eng.add_audio_pcm("c", f"t{i}", synth_tone(300 + 200 * i, 1.0, SR), SR)
            names.append(e.uuid)
        # build the device view, then delete row 0 from the live catalog
        eng.store.device_db()
        view = eng.store.view_entries()
        eng.delete_audio(names[0])
        # the snapshot still maps the OLD row order
        assert [e.uuid for e in view] == names
        # a fresh view keeps the tombstoned row slot (masked off) so row
        # attribution never shifts without a rebuild...
        eng.store.device_db()
        assert [e.uuid for e in eng.store.view_entries()] == names
        # ...and compaction reclaims it
        eng.store.compact()
        eng.store.device_db()
        assert [e.uuid for e in eng.store.view_entries()] == names[1:]


class TestSnapshotTiebreakRace:
    def test_rank_immune_to_concurrent_replace(self, tmp_path):
        """The D5 tiebreak rank must come from the captured snapshot, not
        the live store: a delete+add between vote computation and ranking
        keeps the entry count equal but shifts every positional rank."""
        eng = Tiresias(TiresiasConfig(data_dir=str(tmp_path)), restore=False)
        eng.create_context("c")
        uuids = []
        for i in range(4):
            e = eng.add_audio_pcm("c", f"t{i}", synth_tone(300 + 150 * i, 1.0, SR), SR)
            uuids.append(e.uuid)
        eng.store.search_views()
        snapshot = eng.store.view_entries()
        # concurrent sync replaces one file: count unchanged, rows shifted
        eng.delete_audio(uuids[1])
        eng.add_audio_pcm("c", "t9", synth_tone(950, 1.0, SR), SR)
        rank = eng._insertion_order(snapshot)
        # the snapshot's own insertion order, not the live store's
        assert list(rank) == [0, 1, 2, 3]
        # and equal-vote ties in a live search still break deterministically
        r = eng.search_pcm("c", synth_tone(300, 0.8, SR), SR, tolerance=1.0)
        assert r.found


def _fp(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-30, 20, (n, 2)).astype(np.float32)


class TestStoreReviewRound3:
    """Round-3 store review findings: duplicate-uuid corruption, silent
    empty-store on unreadable checkpoints, unlocked catalog serialization."""

    def test_duplicate_uuid_rejected(self):
        store = FingerprintStore(n_coefs=2)
        store.create_context("c")
        e = store.add_audio("a", "c", _fp(5), "h1", uuid="U1")
        assert e is not None
        with pytest.raises(ValueError, match="already exists"):
            store.add_audio("b", "c", _fp(6, 1), "h2", uuid="U1")
        # the original row is intact and deletable
        assert store.get_audio("U1").name == "a"
        assert store.delete_audio("U1")
        assert len(store) == 0

    def test_unreadable_checkpoint_refuses_empty_start(self, tmp_path):
        from tiresias_tpu.store.fingerprint_store import CheckpointUnreadable

        store = FingerprintStore(n_coefs=2)
        store.create_context("c")
        store.add_audio("a", "c", _fp(5), "h1")
        store.save(str(tmp_path))
        store.add_audio("b", "c", _fp(6, 1), "h2")
        store.save(str(tmp_path))
        (tmp_path / "catalog.json").write_text("junk")
        (tmp_path / "catalog.json.bak").write_text("junk")
        with pytest.raises(CheckpointUnreadable):
            FingerprintStore.load(str(tmp_path), n_coefs=2)
        # segment data was NOT garbage-collected by the failed load
        assert any(p.name.endswith(".npy") for p in tmp_path.iterdir())

    def test_failed_catalog_write_rolls_back_dirty_tracking(
        self, tmp_path, monkeypatch
    ):
        """If the catalog commit fails after the dirty segments were
        written, the rows must stay dirty so the NEXT save rewrites them
        into a generation its catalog actually references."""
        store = FingerprintStore(n_coefs=2)
        store.create_context("c")
        store.add_audio("a", "c", _fp(5), "h1")
        store.save(str(tmp_path))
        store.add_audio("b", "c", _fp(6, 1), "h2")
        real_dump = json.dump
        calls = {"n": 0}

        def boom(*a, **k):
            calls["n"] += 1
            if calls["n"] == 1:
                raise OSError("disk full")
            return real_dump(*a, **k)

        monkeypatch.setattr(json, "dump", boom)
        with pytest.raises(OSError):
            store.save(str(tmp_path))
        store.save(str(tmp_path))  # retry succeeds
        loaded = FingerprintStore.load(str(tmp_path), n_coefs=2)
        assert sorted(e.name for e in loaded.entries) == ["a", "b"]
        np.testing.assert_array_equal(
            loaded.get_fingerprint(store.entries[1].uuid), _fp(6, 1)
        )

    def test_mutation_during_catalog_serialization_not_lost(
        self, tmp_path, monkeypatch
    ):
        """The catalog JSON is serialized OUTSIDE the store lock; an add
        that lands in that window must be excluded from the in-flight
        snapshot but persisted by the next save."""
        store = FingerprintStore(n_coefs=2)
        store.create_context("c")
        store.add_audio("a", "c", _fp(5), "h1")
        real_dump = json.dump
        mutated = {"done": False}

        def dump_and_mutate(obj, f, **k):
            if not mutated["done"]:
                mutated["done"] = True
                store.add_audio("late", "c", _fp(7, 2), "h9")
            return real_dump(obj, f, **k)

        monkeypatch.setattr(json, "dump", dump_and_mutate)
        store.save(str(tmp_path))
        snap = FingerprintStore.load(str(tmp_path), n_coefs=2)
        assert sorted(e.name for e in snap.entries) == ["a"]
        store.save(str(tmp_path))
        now = FingerprintStore.load(str(tmp_path), n_coefs=2)
        assert sorted(e.name for e in now.entries) == ["a", "late"]
        np.testing.assert_array_equal(
            now.get_fingerprint(store.entries[1].uuid), _fp(7, 2)
        )


class TestKernelGateReviewFixes:
    """Ops review: kernel shape rules, tolerance cap on value-encoded
    masking, specs validation, chunked device map build."""

    def test_fit_gates_count_output_block(self):
        """The Triton kernels tile their output over the grid, so the
        audio count enters the rules only through int32 addressing."""
        from tiresias_tpu.ops.match_pallas import (
            aligned_kernel_serves,
            bag_kernel_serves,
        )

        assert bag_kernel_serves(1024, 128 * 1024 * 2)
        assert bag_kernel_serves(1024, 1_000_000 * 1024 * 2 // 1000)
        assert not bag_kernel_serves(1024, 2**31)
        assert aligned_kernel_serves(2, 1024 * 1024 * 2)
        assert not aligned_kernel_serves(2, 2**31)

    def test_pallas_tolerance_cap_rejected(self):
        from tiresias_tpu.ops.match_pallas import search_batch_pallas

        db = np.full((4, 128, 2), -20.0, np.float32)
        q = np.zeros((1, 8, 2), np.float32)
        with pytest.raises(ValueError, match="value-encoded"):
            search_batch_pallas(
                db, q, np.array([8]), coefs=2, tolerance=1e6,
                trunc_coef1=False, interpret=True,
            )

    def test_prefiltered_votes_requires_specs(self):
        from tiresias_tpu.ops.match_pallas import aligned_prefiltered_votes

        db = np.full((4, 128, 2), -20.0, np.float32)
        q = np.zeros((1, 8, 2), np.float32)
        act = np.ones((1, 8), bool)
        with pytest.raises(ValueError, match="specs"):
            aligned_prefiltered_votes(db, (), q, act, act, 0.1)

    def test_value_map_device_build_chunked_matches_block(self, monkeypatch):
        import jax.numpy as jnp

        import tiresias_tpu.ops.match_lattice as ml

        rng = np.random.default_rng(7)
        a, t = 50, 16
        db0 = rng.uniform(-40, 30, (a, t)).astype(np.float32)
        mask = rng.random((a, t)) > 0.2
        ref = np.asarray(ml._build_value_map_block(db0, mask))
        monkeypatch.setattr(ml, "_BUILD_CHUNK", 16)
        got = np.asarray(ml.build_value_map(jnp.asarray(db0), jnp.asarray(mask)))
        np.testing.assert_array_equal(got, ref)


class TestUtilsConfigReviewFixes:
    """Round-3 utils/config review: INI interpolation, float WAVs in pure
    Python, bounded metrics, failing-phase timing, empty-DB top1."""

    def test_percent_in_config_value(self, tmp_path):
        from tiresias_tpu.config import load_config

        d = tmp_path / "100%tones"
        d.mkdir()
        conf = tmp_path / "t.conf"
        conf.write_text(
            f"[global]\ndata_dir={tmp_path}/data\n\n[m]\ndirectory={d}\n"
        )
        cfg = load_config(str(conf))
        assert cfg.contexts[0].directory.endswith("100%tones")

    def test_hop_size_zero_rejected(self):
        from tiresias_tpu.config import DspConfig

        with pytest.raises(ValueError, match="hop_size"):
            DspConfig(hop_size=0)
        with pytest.raises(ValueError, match="hop_size"):
            DspConfig(hop_size=-256)

    def test_float32_wav_pure_python(self, tmp_path, monkeypatch):
        """IEEE-float WAVs (format 3) must decode without the native libs
        (stdlib wave rejects them)."""
        import struct
        import wave as wave_mod

        from tiresias_tpu.utils.audio import read_audio, synth_tone

        monkeypatch.setenv("TIRESIAS_DISABLE_NATIVE", "1")
        pcm = synth_tone(440, 0.25, 8000).astype("<f4")
        raw = pcm.tobytes()
        fmt = struct.pack("<HHIIHH", 3, 1, 8000, 8000 * 4, 4, 32)
        body = (b"fmt " + struct.pack("<I", len(fmt)) + fmt
                + b"data" + struct.pack("<I", len(raw)) + raw)
        path = tmp_path / "f32.wav"
        path.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(body))
                         + b"WAVE" + body)
        with pytest.raises(wave_mod.Error):
            wave_mod.open(str(path), "rb")  # stdlib really can't read it
        got, sr = read_audio(str(path))
        assert sr == 8000
        np.testing.assert_allclose(got, pcm, atol=1e-7)

    def test_metrics_timings_bounded(self):
        from tiresias_tpu.utils.tracing import Metrics

        m = Metrics()
        for i in range(Metrics.MAX_SAMPLES + 500):
            m.record_time("x", float(i))
        snap = m.snapshot()
        assert len(snap["timings"]["x"]) == Metrics.MAX_SAMPLES
        # the WINDOW is the most recent samples
        assert snap["timings"]["x"][0] == 500.0

    def test_phase_records_on_raise(self):
        from tiresias_tpu.utils.tracing import metrics, phase

        before = len(metrics.snapshot()["timings"].get("boom.phase", ()))
        with pytest.raises(RuntimeError):
            with phase("boom.phase"):
                raise RuntimeError("x")
        after = len(metrics.snapshot()["timings"].get("boom.phase", ()))
        assert after == before + 1

    def test_top1_empty_db(self):
        import jax.numpy as jnp

        from tiresias_tpu.ops import match_jax

        best, count = match_jax.top1(jnp.zeros((3, 0), jnp.int32))
        assert list(np.asarray(best)) == [-1, -1, -1]
        assert list(np.asarray(count)) == [0, 0, 0]
        # and through search_batch's public contract
        db = np.zeros((0, 128, 2), np.float32)
        mask = np.zeros((0, 128), bool)
        q = np.zeros((2, 8, 2), np.float32)
        b, c, votes = match_jax.search_batch(db, mask, q, np.array([8, 8]))
        assert list(np.asarray(b)) == [-1, -1]
        assert votes.shape == (2, 0)


class TestCheckpointRotationSafety:
    """Round-3 store review: a corrupt current catalog must never rotate
    over the good .bak, and resumed lineages must never overwrite a
    successor's committed segment files."""

    def _store(self, names):
        s = FingerprintStore(n_coefs=2)
        s.create_context("c")
        for i, n in enumerate(names):
            s.add_audio(n, "c", _fp(5, i), f"h{n}")
        return s

    def test_corrupt_current_not_rotated_over_good_bak(self, tmp_path):
        d = str(tmp_path)
        s = self._store(["a"])
        s.save(d)
        s.add_audio("b", "c", _fp(6, 9), "hb")
        s.save(d)  # current=gen2(a,b), .bak=gen1(a)
        (tmp_path / "catalog.json").write_text("junk")  # current corrupt
        loaded = FingerprintStore.load(d, n_coefs=2)  # falls back to .bak
        assert sorted(e.name for e in loaded.entries) == ["a"]
        loaded.add_audio("c2", "c", _fp(7, 3), "hc")
        loaded.save(d)  # must NOT rotate the junk over the good .bak
        # the new current is fine...
        now = FingerprintStore.load(d, n_coefs=2)
        assert sorted(e.name for e in now.entries) == ["a", "c2"]
        # ...and if IT gets corrupted, the fallback still restores the
        # pre-corruption good generation (data survived two fault rounds)
        (tmp_path / "catalog.json").write_text("junk")
        fb = FingerprintStore.load(d, n_coefs=2)
        assert sorted(e.name for e in fb.entries) == ["a"]

    def test_resumed_lineage_never_overwrites_successor_segments(
        self, tmp_path
    ):
        d = str(tmp_path)
        a = self._store(["a1"])
        a.save(d)  # a considers d its save dir now
        b = FingerprintStore.load(d, n_coefs=2)  # successor takes over
        b.add_audio("b1", "c", _fp(6, 5), "hb1")
        b.save(d)  # b's generation becomes current
        # the old lineage resumes saving WITHOUT re-loading: its files
        # must land in a HIGHER generation, not overwrite b's
        a.add_audio("a2", "c", _fp(6, 6), "ha2")
        a.save(d)
        # b's generation was rotated to .bak; corrupting a's current must
        # restore b's data intact (same rows b committed)
        (tmp_path / "catalog.json").write_text("junk")
        fb = FingerprintStore.load(d, n_coefs=2)
        assert sorted(e.name for e in fb.entries) == ["a1", "b1"]
        np.testing.assert_array_equal(
            fb.get_fingerprint(fb.entries[1].uuid), _fp(6, 5)
        )
