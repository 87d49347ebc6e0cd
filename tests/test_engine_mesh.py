"""Engine with a sharded store: multi-chip search via GSPMD.

An engine constructed with a ``(db, batch)`` mesh shards the fingerprint DB
across the 8 virtual devices; searches must return exactly what the
single-device engine returns.
"""

import numpy as np
import pytest

import jax

from tiresias_tpu.api import Tiresias
from tiresias_tpu.config import TiresiasConfig
from tiresias_tpu.parallel import make_mesh
from tiresias_tpu.utils.audio import synth_chirp, synth_tone

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)

SR = 8000


def _build(tmp_path, mesh):
    eng = Tiresias(
        TiresiasConfig(data_dir=str(tmp_path)), restore=False, mesh=mesh
    )
    eng.create_context("m")
    for i in range(10):
        pcm = (
            synth_tone(250 + 140 * i, 1.0, SR)
            if i % 2
            else synth_chirp(200 + 90 * i, 900 + 150 * i, 1.0, SR)
        )
        eng.add_audio_pcm("m", f"clip{i}", pcm, SR)
    return eng


def test_auto_mesh(tmp_path):
    eng = Tiresias(
        TiresiasConfig(data_dir=str(tmp_path)), restore=False, mesh="auto"
    )
    assert eng.mesh is not None and eng.mesh.devices.size == len(jax.devices())
    eng.create_context("m")
    eng.add_audio_pcm("m", "t", synth_tone(440, 1.0, SR), SR)
    r = eng.search_pcm("m", synth_tone(440, 1.0, SR), SR, tolerance=1.0)
    assert r.found and r.name == "t"


def test_streaming_over_sharded_engine(tmp_path):
    """End-to-end multi-chip serving: the streaming scorer drives a
    mesh-sharded store; results must match the single-device engine."""
    from tiresias_tpu.serve import StreamingRecognizer

    mesh = make_mesh(4, 2)
    eng = _build(tmp_path / "m", mesh)
    rec = StreamingRecognizer(eng, samplerate=SR)
    seen = {}
    for i in (0, 3, 6):
        rec.open(
            f"ch{i}", context="m", duration_ms=700,
            coefs=2, tolerance=0.01, trunc_coef1=False,
            on_result=lambda cid, r: seen.setdefault(cid, r),
        )
        pcm = (
            synth_tone(250 + 140 * i, 0.8, SR)
            if i % 2
            else synth_chirp(200 + 90 * i, 900 + 150 * i, 0.8, SR)
        )
        rec.push(f"ch{i}", pcm)
    results = rec.process_ready()
    assert set(results) == {"ch0", "ch3", "ch6"}
    for i in (0, 3, 6):
        assert results[f"ch{i}"].name == f"clip{i}", results[f"ch{i}"]


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_sharded_engine_matches_single(tmp_path, mesh_shape):
    mesh = make_mesh(*mesh_shape)
    sharded = _build(tmp_path / "a", mesh)
    single = _build(tmp_path / "b", None)

    db, _, n = sharded.store.device_db()
    assert db.sharding.is_fully_replicated is False  # actually sharded

    queries = [synth_tone(250 + 140 * i, 0.7, SR) for i in (1, 3, 5)]
    for kwargs in (
        dict(tolerance=1.0),  # lattice path
        dict(coefs=2, tolerance=0.01, trunc_coef1=False),  # generic path
        dict(tolerance=1.0, filter_context=True),  # context filter
        # the accuracy mode on a SHARDED store (GSPMD partitions the
        # aligned XLA matcher over the db axis)
        dict(coefs=2, tolerance=0.05, trunc_coef1=False, aligned=True),
    ):
        rs = sharded.search_pcm_batch("m", queries, SR, **kwargs)
        r1 = single.search_pcm_batch("m", queries, SR, **kwargs)
        assert [(r.name, r.match_count, r.frame_count) for r in rs] == [
            (r.name, r.match_count, r.frame_count) for r in r1
        ], kwargs


def test_live_append_keeps_views_sharded(tmp_path):
    """A live add_audio after the first search must take the incremental
    view-update path WITHOUT un-sharding the device views (the update is
    pinned back to P('db')), and post-append searches must match a fresh
    single-device engine."""
    from jax.sharding import NamedSharding, PartitionSpec

    mesh = make_mesh(4, 2)
    eng = _build(tmp_path / "a", mesh)
    # first search builds + caches the views (and the lattice value map)
    r = eng.search_pcm("m", synth_tone(390, 0.7, SR), SR, tolerance=1.0)
    assert r.found
    views_before = eng.store.search_views()

    for i in range(10, 14):
        eng.add_audio_pcm("m", f"clip{i}", synth_tone(250 + 140 * i, 1.0, SR), SR)
    # prove the append goes through the incremental path: a full rebuild
    # would call _device_put, which is forbidden for the next rebuild
    def _no_rebuild(*a, **k):
        raise AssertionError("append fell back to a full view rebuild")

    eng.store._device_put = _no_rebuild
    views = eng.store.search_views()
    del eng.store._device_put  # restore the class method for later queries
    # incremental path taken: the padded buffer object was updated, not rebuilt
    assert views[0].n_audios == views_before[0].n_audios + 4
    for v in views:
        assert v.db.sharding == NamedSharding(mesh, PartitionSpec("db", None, None)), (
            v.db.sharding
        )
        assert v.mask.sharding == NamedSharding(mesh, PartitionSpec("db", None))
        if v.value_map is not None:
            assert "db" in str(v.value_map.sharding), v.value_map.sharding

    single = _build(tmp_path / "b", None)
    for i in range(10, 14):
        single.add_audio_pcm("m", f"clip{i}", synth_tone(250 + 140 * i, 1.0, SR), SR)
    queries = [synth_tone(250 + 140 * i, 0.7, SR) for i in (2, 11, 13)]
    for kwargs in (
        dict(tolerance=1.0),  # lattice path exercises the value-map update
        dict(coefs=2, tolerance=0.01, trunc_coef1=False),
    ):
        rs = eng.search_pcm_batch("m", queries, SR, **kwargs)
        r1 = single.search_pcm_batch("m", queries, SR, **kwargs)
        assert [(r.name, r.match_count) for r in rs] == [
            (r.name, r.match_count) for r in r1
        ], kwargs


def test_sharded_engine_fused_pallas_dispatch(tmp_path, monkeypatch):
    """Sharded store: the engine must route generic and ALIGNED searches
    through the shard-mapped fused matcher (the XLA form on the CPU mesh,
    the Triton kernels on a GPU mesh — one dispatch) and still match the
    single-device engine."""
    import tiresias_tpu.parallel.sharding as sharding_mod

    calls = []
    real = sharding_mod.sharded_votes_pallas

    def spy(*args, **kwargs):
        calls.append(kwargs.get("aligned", False))
        return real(*args, **kwargs)

    monkeypatch.setattr(sharding_mod, "sharded_votes_pallas", spy)

    mesh = make_mesh(4, 2)
    sharded = _build(tmp_path / "a", mesh)
    single = _build(tmp_path / "b", None)
    queries = [synth_tone(250 + 140 * i, 0.7, SR) for i in (1, 3, 5)]
    for kwargs in (
        dict(coefs=2, tolerance=0.01, trunc_coef1=False),
        dict(coefs=2, tolerance=0.05, trunc_coef1=False, aligned=True),
    ):
        rs = sharded.search_pcm_batch("m", queries, SR, **kwargs)
        r1 = single.search_pcm_batch("m", queries, SR, **kwargs)
        assert [(r.name, r.match_count, r.frame_count) for r in rs] == [
            (r.name, r.match_count, r.frame_count) for r in r1
        ], kwargs
    assert calls == [False, True]  # both kernels actually dispatched


def test_sharded_engine_prefilter_dispatch(tmp_path, monkeypatch):
    """Sharded store: aligned searches above the (monkeypatched) per-shard
    budget must route through the shard-mapped certified prefilter and
    match the single-device engine — including context-filtered."""
    import tiresias_tpu.ops.match_pallas as mp

    monkeypatch.setattr(mp, "PREFILTER_K", 1)  # open the engine gate
    mesh = make_mesh(4, 2)
    sharded = _build(tmp_path / "a", mesh)
    single = _build(tmp_path / "b", None)
    for eng in (sharded, single):
        eng.create_context("x")
        eng.add_audio_pcm("x", "decoy", synth_tone(390, 1.0, SR), SR)

    ran = {"n": 0, "calls": 0}
    orig = sharded._aligned_prefiltered

    def spy(*a, **k):
        ran["calls"] += 1
        out = orig(*a, **k)
        if out is not None:
            ran["n"] += 1
        return out

    monkeypatch.setattr(sharded, "_aligned_prefiltered", spy)
    queries = [synth_tone(250 + 140 * i, 0.7, SR) for i in (1, 3)]
    kwargs = dict(coefs=2, tolerance=0.05, trunc_coef1=False, aligned=True)
    rs = sharded.search_pcm_batch("m", queries, SR, **kwargs)
    r1 = single.search_pcm_batch("m", queries, SR, **kwargs)
    assert [(r.name, r.match_count) for r in rs] == [
        (r.name, r.match_count) for r in r1
    ]
    assert ran["n"] >= 1  # the sharded prefilter actually served it
    # context-filtered through the same path: decoy context finds nothing
    before = ran["n"]
    rf = sharded.search_pcm(
        "x", queries[0], SR, filter_context=True, **kwargs
    )
    f1 = single.search_pcm(
        "x", queries[0], SR, filter_context=True, **kwargs
    )
    assert rf.status == f1.status and rf.name == f1.name
    assert ran["n"] == before + 1
    # past the uint8 bound-map saturation the certificate can never
    # hold — the sharded dispatch must bypass the prefilter entirely
    # (not run it and fall back) and still answer correctly
    before = ran["calls"]
    sat = dict(coefs=2, tolerance=1.0, trunc_coef1=False, aligned=True)
    rs2 = sharded.search_pcm("m", queries[0], SR, **sat)
    r12 = single.search_pcm("m", queries[0], SR, **sat)
    assert (rs2.status, rs2.name) == (r12.status, r12.name)
    assert ran["calls"] == before  # tolerance gate rejected the pipeline


def test_sharded_engine_wire_law(tmp_path):
    """G.711 trunk-byte queries against a mesh-sharded store: the uint8
    batch decodes on (virtual) device inside the GSPMD search and matches
    the single-device linear result exactly."""
    from tiresias_tpu.utils import g711
    from tiresias_tpu.utils.audio import float_to_i16

    mesh = make_mesh(4, 2)
    eng_m = _build(tmp_path / "m", mesh)
    eng_s = _build(tmp_path / "s", None)
    try:
        q = float_to_i16(synth_chirp(380, 1170, 1.0, SR))  # clip2's shape
        wire = g711.encode_ulaw(q)
        lin = g711.decode(wire, "ulaw")
        for kw in (
            dict(tolerance=1.0),
            dict(tolerance=0.05, coefs=2, trunc_coef1=False),
            dict(tolerance=0.05, coefs=2, trunc_coef1=False, aligned=True),
        ):
            r_m = eng_m.search_pcm("m", wire, SR, wire_law="ulaw", **kw)
            r_s = eng_s.search_pcm("m", lin, SR, **kw)
            assert (r_m.status, r_m.name, r_m.match_count) == (
                r_s.status, r_s.name, r_s.match_count
            )
    finally:
        eng_m.close()
        eng_s.close()


def test_sharded_engine_lattice_prefilter_dispatch(tmp_path, monkeypatch):
    """Sharded store: DIALPLAN searches above the (monkeypatched)
    per-shard budget route through the shard-mapped certified lattice
    prefilter and match the single-device engine exactly — certified or
    decertified (the fallback is the exact GSPMD full scan)."""
    import tiresias_tpu.ops.match_lattice as mlmod

    monkeypatch.setattr(mlmod, "LATTICE_PREFILTER_K", 1)  # open the gate
    mesh = make_mesh(4, 2)
    sharded = _build(tmp_path / "a", mesh)
    single = _build(tmp_path / "b", None)
    # the fused one-dispatch path serves single-tier stores first (GSPMD
    # full scan on a mesh); disable it so the STAGED sharded path — the
    # one that consults the shard-mapped prefilter — handles the search,
    # exactly as it does for multi-tier stores and top-k listings
    monkeypatch.setattr(sharded, "_fused_search_batch", lambda *a, **k: None)

    ran = {"n": 0}
    orig = sharded._lattice_prefiltered

    def spy(*a, **k):
        ran["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(sharded, "_lattice_prefiltered", spy)
    queries = [synth_tone(250 + 140 * i, 0.7, SR) for i in (1, 3)]
    for tol in (1.0, 0.01):
        rs = sharded.search_pcm_batch("m", queries, SR, tolerance=tol)
        r1 = single.search_pcm_batch("m", queries, SR, tolerance=tol)
        assert [(r.status, r.name, r.match_count) for r in rs] == [
            (r.status, r.name, r.match_count) for r in r1
        ]
    assert ran["n"] >= 1  # the sharded lattice prefilter was consulted
