"""Certified lattice (dialplan-path) prefilter — PARITY.md D19.

The uint8-quantized companion of the dialplan distance map bounds every
audio's vote count from above (floor-scaling only under-states
distances); rescoring the top-k candidates on the exact f32 map is
provably identical to the full scan whenever the certificate holds.
These tests pin the bound's validity (dominance for ANY tolerance), the
certified result's exactness against the full lattice scan, the band /
context / auto-split interactions, the incremental store maintenance of
the quantized map, and the engine dispatch (staged + fused one-dispatch
paths, with the lax.cond full-scan fallback).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tiresias_tpu.ops import match_lattice as ml
from tiresias_tpu.ops.mfcc_jax import PAD_VALUE


def _clustered(seed=0, n_audios=256, t=64):
    """Per-audio clustered max1 values: bounds are selective, so the
    small-k certificates in these tests hold by construction."""
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-25, 20, size=(n_audios, 1)).astype(np.float32)
    db0 = (mu + rng.normal(0, 1.5, (n_audios, t))).astype(np.float32)
    n_frames = rng.integers(t // 2, t + 1, size=n_audios)
    mask = np.arange(t)[None, :] < n_frames[:, None]
    db0 = np.where(mask, db0, PAD_VALUE).astype(np.float32)
    return db0, mask


def _maps(db0, mask):
    vm = ml.build_value_map(jnp.asarray(db0), jnp.asarray(mask))
    return vm, ml.quantize_value_map(vm)


class TestQuantizedMap:
    def test_dtype_and_sentinel(self):
        db0, mask = _clustered()
        mask[7] = False  # a dead row
        vm, vmq = _maps(db0, mask)
        assert vmq.dtype == jnp.uint8
        q_np = np.asarray(vmq)
        assert (q_np[7] == ml.BOUND_FAR).all()  # +inf row -> sentinel
        assert (q_np[0] < ml.BOUND_FAR).any()  # live rows keep distances

    def test_floor_understates(self):
        """floor(d*Q) <= d*Q everywhere (finite cells), so the quantized
        hit test is a superset of the exact one for any tolerance."""
        db0, mask = _clustered()
        vm, vmq = _maps(db0, mask)
        v = np.asarray(vm)
        q = np.asarray(vmq).astype(np.float64)
        finite = np.isfinite(v)
        assert (q[finite] <= v[finite] * ml.BOUND_Q).all()

    @pytest.mark.parametrize("tolerance", [0.001, 0.05, 1.0, 3.0])
    def test_bound_dominates_exact_votes(self, tolerance):
        """THE core inequality, for any tolerance the engine gate admits:
        quantized-map votes >= exact-map votes per audio."""
        db0, mask = _clustered(seed=3)
        vm, vmq = _maps(db0, mask)
        rng = np.random.default_rng(9)
        q = np.stack([
            db0[11, :48], rng.uniform(-30, 25, size=48).astype(np.float32),
        ])
        active = np.ones((2, 48), bool)
        exact = np.asarray(
            ml.lattice_votes(vm, jnp.asarray(q), jnp.asarray(active),
                             tolerance, -np.inf, np.inf)
        )
        bound = np.asarray(
            ml.lattice_votes(vmq, jnp.asarray(q), jnp.asarray(active),
                             tolerance * ml.BOUND_Q, -np.inf, np.inf)
        )
        assert (bound >= exact).all()


class TestPrefilteredVotes:
    def _parity(self, tol, band=(-np.inf, np.inf), k=32, seed=1):
        db0, mask = _clustered(seed=seed)
        vm, vmq = _maps(db0, mask)
        rng = np.random.default_rng(seed + 100)
        q = np.stack([
            db0[11, :48], rng.uniform(-30, 25, size=48).astype(np.float32),
        ])
        active = np.ones((2, 48), bool)
        active[0, 40:] = False
        full = np.asarray(
            ml.lattice_votes(vm, jnp.asarray(q), jnp.asarray(active), tol,
                             band[0], band[1])
        )
        votes, cert = ml.lattice_prefiltered_votes(
            vm, vmq, jnp.asarray(q), jnp.asarray(active), tol,
            band[0], band[1], k=k,
        )
        return full, np.asarray(votes), np.asarray(cert)

    @pytest.mark.parametrize("tol", [0.001, 0.05, 0.5])
    def test_certified_matches_full_scan(self, tol):
        full, votes, cert = self._parity(tol)
        assert cert.all()
        # candidate votes exact, others zeroed but never beating the winner
        assert (votes <= full).all()
        for b in range(2):
            assert votes[b].argmax() == full[b].argmax()
            assert votes[b].max() == full[b].max()

    def test_band_filter_parity(self):
        full, votes, cert = self._parity(0.05, band=(-20.0, 10.0))
        assert cert.all()
        for b in range(2):
            assert votes[b].argmax() == full[b].argmax()
            assert votes[b].max() == full[b].max()

    def test_context_filter(self):
        db0, mask = _clustered(seed=5)
        vm, vmq = _maps(db0, mask)
        q = db0[None, 200, :48]  # target lives in context 1's half
        active = np.ones((1, 48), bool)
        ctx = np.zeros(db0.shape[0], np.int32)
        ctx[128:] = 1
        full = np.asarray(
            ml.lattice_votes(vm, jnp.asarray(q), jnp.asarray(active), 0.05,
                             -np.inf, np.inf)
        )
        full = np.where((ctx == 1)[None, :], full, 0)
        votes, cert = ml.lattice_prefiltered_votes(
            vm, vmq, jnp.asarray(q), jnp.asarray(active), 0.05,
            -np.inf, np.inf, k=32, ctx_ids=jnp.asarray(ctx), ctx_id=1,
        )
        votes = np.asarray(votes)
        assert np.asarray(cert).all()
        assert (votes[:, :128] == 0).all()  # out-of-context stays zero
        assert full[0].max() > 0  # the filtered corpus really matches
        assert votes[0].argmax() == full[0].argmax()
        assert votes[0].max() == full[0].max()

    def test_near_duplicates_decertify(self):
        """>k rows tied at the top: the certificate must refuse (kth best
        cannot strictly beat the unselected max) — exactness is preserved
        by the caller's full-scan fallback, never by a silent wrong
        answer."""
        db0, mask = _clustered(seed=7)
        db0[:64] = db0[0]  # 64 identical rows, k=16 candidates
        mask[:64] = mask[0]
        vm, vmq = _maps(db0, mask)
        q = db0[None, 0, :48]
        active = np.ones((1, 48), bool)
        # tolerance 1.0 swallows the (int) truncation loss, so all 64
        # duplicates tie at the full frame count — far beyond k=16
        _, cert = ml.lattice_prefiltered_votes(
            vm, vmq, jnp.asarray(q), jnp.asarray(active), 1.0,
            -np.inf, np.inf, k=16,
        )
        assert not np.asarray(cert).any()

    def test_topk_certificate(self):
        """top=3 listing: when certified, scattering the candidate votes
        yields the exact top-3 rows of the full scan."""
        db0, mask = _clustered(seed=11)
        # two noisy near-copies of row 40 so the listing has >1 real hit
        db0[41] = db0[40] + 0.02
        db0[42] = db0[40] - 0.02
        mask[41] = mask[42] = mask[40]
        vm, vmq = _maps(db0, mask)
        q = db0[None, 40, :48]
        active = np.ones((1, 48), bool)
        full = np.asarray(
            ml.lattice_votes(vm, jnp.asarray(q), jnp.asarray(active), 0.1,
                             -np.inf, np.inf)
        )[0]
        votes, cert = ml.lattice_prefiltered_votes(
            vm, vmq, jnp.asarray(q), jnp.asarray(active), 0.1,
            -np.inf, np.inf, k=32, top=3,
        )
        assert np.asarray(cert).all()
        votes = np.asarray(votes)[0]
        order_full = np.lexsort((np.arange(full.size), -full))[:3]
        order_pre = np.lexsort((np.arange(votes.size), -votes))[:3]
        np.testing.assert_array_equal(order_pre, order_full)
        np.testing.assert_array_equal(votes[order_pre], full[order_full])


class TestStoreMaintenance:
    def _store(self, tmp_path):
        from tiresias_tpu.store import FingerprintStore

        s = FingerprintStore(n_coefs=2)
        s.create_context("c", str(tmp_path))
        return s

    def _add(self, store, name, values, seed=None):
        rng = np.random.default_rng(seed if seed is not None else 0)
        t = len(values)
        fp = np.stack(
            [np.asarray(values, np.float32),
             rng.uniform(-5, 5, t).astype(np.float32)], axis=1
        )
        return store.add_audio(name, "c", fp, name, uuid=name)

    def test_append_extends_quantized_map(self, tmp_path):
        store = self._store(tmp_path)
        for i in range(4):
            self._add(store, f"a{i}", np.full(32, -10.0 + i), seed=i)
        v1 = store.search_views()[0]
        store.value_map_q_for(v1)  # build both maps
        for i in range(4, 7):
            self._add(store, f"a{i}", np.full(32, -10.0 + i), seed=i)
        v2 = store.search_views()[0]
        assert v2.value_map_q is not None, "append dropped the u8 map"
        got = np.asarray(store.value_map_q_for(v2))
        fresh = np.asarray(
            ml.quantize_value_map(
                ml.build_value_map(v2.db[..., 0], v2.mask)
            )
        )
        np.testing.assert_array_equal(got, fresh)

    def test_delete_scatters_sentinel(self, tmp_path):
        store = self._store(tmp_path)
        for i in range(4):
            self._add(store, f"a{i}", np.full(32, -10.0 + i), seed=i)
        v1 = store.search_views()[0]
        store.value_map_q_for(v1)
        store.delete_audio("a1")
        v2 = store.search_views()[0]
        assert v2.value_map_q is not None, "delete dropped the u8 map"
        got = np.asarray(store.value_map_q_for(v2))
        assert (got[1] == ml.BOUND_FAR).all()
        assert (got[0] < ml.BOUND_FAR).any()


class TestEngineDispatch:
    @pytest.fixture()
    def eng(self, tmp_path, monkeypatch):
        from tiresias_tpu.api import Tiresias
        from tiresias_tpu.api import engine as engine_mod
        from tiresias_tpu.config import TiresiasConfig

        # small candidate budget so a 40-audio store crosses the
        # size gate; the fused-fn cache keys on k so no cross-test bleed
        monkeypatch.setattr(
            "tiresias_tpu.ops.match_lattice.LATTICE_PREFILTER_K", 8
        )
        engine_mod._fused_lattice_fn.cache_clear()
        e = Tiresias(TiresiasConfig(data_dir=str(tmp_path)), restore=False)
        e.create_context("c")
        yield e
        e.close()
        engine_mod._fused_lattice_fn.cache_clear()

    SR = 8000

    def _fill(self, eng, n=40):
        from tiresias_tpu.utils.audio import synth_tone

        for i in range(n):
            eng.add_audio_pcm(
                "c", f"t{i}", synth_tone(200 + 17 * i, 1.0, self.SR), self.SR
            )

    def _control(self, eng, fn):
        """Run ``fn`` with the prefilter gate forced off (the exact
        full-scan path) — the parity oracle for every dispatch test."""
        import tiresias_tpu.ops.match_lattice as mlmod

        old = mlmod.LATTICE_PREFILTER_K
        mlmod.LATTICE_PREFILTER_K = 10**9  # size gate never passes
        try:
            return fn()
        finally:
            mlmod.LATTICE_PREFILTER_K = old

    def test_fused_prefilter_matches_full(self, eng):
        """Whatever the D5 winner is (pure tones tie heavily at tol 1.0 —
        ties are the hard case), the one-dispatch prefiltered search must
        return exactly the full scan's answer, certified or not."""
        from tiresias_tpu.utils.audio import synth_tone

        self._fill(eng)
        view = eng.store.search_views()[0]
        assert view.db.shape[0] > 16  # crosses the 2k gate (k=8)
        for tol in (1.0, 0.5, 0.001):
            for i in (11, 0, 39):
                q = synth_tone(200 + 17 * i, 1.0, self.SR)
                r = eng.search_pcm("c", q, self.SR, tolerance=tol)
                rf = self._control(
                    eng,
                    lambda: eng.search_pcm("c", q, self.SR, tolerance=tol),
                )
                assert (r.status, r.name, r.match_count) == (
                    rf.status, rf.name, rf.match_count
                )
        # the quantized map was actually built (the gate engaged)
        assert eng.store.search_views()[0].value_map_q is not None
        # and a NOTFOUND stays a NOTFOUND (silence scores zero votes)
        r2 = eng.search_pcm("c", np.zeros(self.SR, np.float32), self.SR,
                            tolerance=0.001)
        assert r2.status == "NOTFOUND"

    def test_staged_prefilter_matches_full(self, eng):
        """With the fused single-dispatch path disabled, batched searches
        go through _votes_for_view's prefiltered branch; results must
        equal the forced full scan exactly."""
        from tiresias_tpu.utils.audio import synth_tone

        self._fill(eng)
        eng._fused_search_batch = lambda *a, **kw: None
        qs = [
            synth_tone(200 + 17 * 3, 1.0, self.SR),
            synth_tone(200 + 17 * 29, 1.0, self.SR),
        ]
        rs = eng.search_pcm_batch("c", qs, self.SR, tolerance=1.0)
        rs_full = self._control(
            eng,
            lambda: eng.search_pcm_batch("c", qs, self.SR, tolerance=1.0),
        )
        assert [(r.status, r.name, r.match_count) for r in rs] == [
            (r.status, r.name, r.match_count) for r in rs_full
        ]

    def test_adaptive_gate_disables_after_miss_streak(self, eng):
        """A corpus whose top-1 genuinely ties beyond k rows de-certifies
        every query; after 8 consecutive misses the engine stops paying
        the bound scan for this view, and any store mutation (new view)
        re-arms the gate."""
        from tiresias_tpu.utils.audio import synth_tone

        tone = synth_tone(440, 1.0, self.SR)
        for i in range(24):
            # amplitude-perturbed copies: distinct MD5s (the store would
            # dedupe exact duplicates, reference fp_handler.c:501-507)
            # whose fingerprints still tie at tolerance 1.0
            eng.add_audio_pcm(
                "c", f"dup{i}", tone * (1.0 + 1e-5 * i), self.SR
            )
        for _ in range(9):
            r = eng.search_pcm("c", tone, self.SR, tolerance=1.0)
            assert r.status == "FOUND" and r.name == "dup0"  # exact always
        view = eng.store.search_views()[0]
        assert eng._pf_misses.get((view.gen, "lattice"), 0) >= 8
        assert not eng._lattice_pf_ok(view, 1.0)
        eng.add_audio_pcm("c", "fresh", synth_tone(999, 1.0, self.SR),
                          self.SR)
        view2 = eng.store.search_views()[0]
        assert view2.gen != view.gen and eng._lattice_pf_ok(view2, 1.0)

    def test_decertified_store_falls_back(self, eng):
        """A store of near-duplicates de-certifies (> k rows tie); the
        engine must still answer exactly via the full-scan branch."""
        from tiresias_tpu.utils.audio import synth_tone

        tone = synth_tone(440, 1.0, self.SR)
        for i in range(24):  # 24 near-identical audios (distinct MD5s), k=8
            eng.add_audio_pcm(
                "c", f"dup{i}", tone * (1.0 + 1e-5 * i), self.SR
            )
        r = eng.search_pcm("c", tone, self.SR, tolerance=1.0)
        # D5: lowest insertion index wins among the ties
        assert r.status == "FOUND" and r.name == "dup0"
        assert r.match_count == r.frame_count


class TestPfMissLru:
    def test_live_streak_survives_stale_churn(self, tmp_path):
        """The miss-dict size bound must evict by NOTE recency, not key
        order: a live view under traffic keeps its streak while stale
        gens churn past the cap (review finding: lowest-gen eviction
        kept resetting the one streak that mattered)."""
        from types import SimpleNamespace

        from tiresias_tpu.api import Tiresias
        from tiresias_tpu.config import TiresiasConfig

        eng = Tiresias(TiresiasConfig(data_dir=str(tmp_path)),
                       restore=False)
        try:
            live = SimpleNamespace(gen=1)
            gen = 2
            for _ in range(7):  # live misses with stale churn between
                eng._pf_note(live, "lattice", False)
                for _ in range(20):  # 140 total stale gens (cap is 32)
                    eng._pf_note(
                        SimpleNamespace(gen=gen), "lattice", False
                    )
                    gen += 1
                assert eng._pf_allowed(live, "lattice")
            assert len(eng._pf_misses) <= 32
            eng._pf_note(live, "lattice", False)  # 8th live miss
            assert not eng._pf_allowed(live, "lattice")
            # a certified result re-arms
            eng._pf_note(live, "lattice", True)
            assert eng._pf_allowed(live, "lattice")
        finally:
            eng.close()


class TestBoundTolOk:
    def test_dialplan_unit_scale(self):
        # the dialplan bound thresholds at tol * 64 (_prefilter_core, no
        # +1 slack) -> saturation at tol >= 255/64 ~ 3.98; must agree
        # with the engine gate (_lattice_pf_ok) exactly
        assert ml.bound_tol_ok(None, 0.001)
        assert ml.bound_tol_ok(None, 1.0)
        assert ml.bound_tol_ok(None, 3.9)
        assert not ml.bound_tol_ok(None, 4.0)
        assert not ml.bound_tol_ok(None, -1.0)

    def test_aligned_scales(self):
        # ANY unsaturated coef keeps the min() bound informative.
        # coefs >= 3 use the (s=8, s=8) specs: (8*tol + 1) * 64 < 255
        # -> tol < ~0.373. coefs == 2 ANDs the s=4 coef-0 spec in
        # (round 5): informative until (4*tol + 1) * 64 >= 255
        # -> tol ~0.746. coefs == 1 has only the s=4 coef-0 spec.
        assert ml.bound_tol_ok(2, 0.05)
        assert ml.bound_tol_ok(8, 0.1)
        assert ml.bound_tol_ok(2, 0.5)   # coef 1 saturated, coef 0 not
        assert not ml.bound_tol_ok(2, 1.0)  # both saturated
        assert not ml.bound_tol_ok(8, 0.5)  # both s=8 specs saturated
        assert ml.bound_tol_ok(1, 0.5)
        assert not ml.bound_tol_ok(1, 1.0)

    def test_engine_gate_skips_saturated_aligned(self, tmp_path,
                                                  monkeypatch):
        """tolerance past saturation must bypass the aligned prefilter
        entirely (the bound could never certify — review finding), not
        run it and fall back. This test asserts the GATING, not the
        matchers (those have their own parity tests)."""
        import tiresias_tpu.ops.match_pallas as mp
        from tiresias_tpu.api import Tiresias
        from tiresias_tpu.config import TiresiasConfig
        from tiresias_tpu.utils.audio import synth_tone

        eng = Tiresias(TiresiasConfig(data_dir=str(tmp_path)),
                       restore=False)
        eng.create_context("c")
        for i in range(4):
            eng.add_audio_pcm("c", f"t{i}",
                              synth_tone(300 + 90 * i, 1.0, 8000), 8000)
        called = {"pf": 0}

        def fake_prefiltered(*a, **k):
            called["pf"] += 1
            return None  # decertify -> dispatch falls to the full scan

        monkeypatch.setattr(mp, "PREFILTER_K", 1)  # open the size gate
        monkeypatch.setattr(eng, "_aligned_prefiltered", fake_prefiltered)
        # this test asserts the STAGED path's gate; the fused strict
        # path would intercept first
        monkeypatch.setattr(eng, "_fused_strict_batch",
                            lambda *a, **k: None)
        try:
            q = synth_tone(300, 1.0, 8000)
            # tol 1.0 saturates BOTH 2-coef bound specs (s=4 coef 0 at
            # ~0.746, s=8 coef 1 at ~0.373) — the gate asks for "any
            # coef informative", so 0.5 does not reject
            r = eng.search_pcm("c", q, 8000, coefs=2, tolerance=1.0,
                               trunc_coef1=False, aligned=True)
            assert r.status == "FOUND"
            assert called["pf"] == 0  # tolerance gate rejected it
            r2 = eng.search_pcm("c", q, 8000, coefs=2, tolerance=0.05,
                                trunc_coef1=False, aligned=True)
            assert r2.status in ("FOUND", "NOTFOUND")
            assert called["pf"] == 1  # informative tolerance ran it
        finally:
            eng.close()
