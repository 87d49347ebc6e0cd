"""Round-5 noise extension: per-coef fingerprint weighting + margin
acceptance (VERDICT r4 #3 — a noise story that survives corpus scale).

Additive noise moves the high-order MFCC coefficients ~6x more than
coef 1 (measured 20 dB profile, tools/margin_study.py), so
``DspConfig.coef_weights`` rescales the LOG-domain fingerprint space so
one scalar tolerance means a per-coef tolerance matched to the noise;
``MatchConfig.min_margin`` gates acceptance on the winner's vote margin
over the runner-up audio (impostors near-tie, true matches win wide).
"""

import numpy as np
import pytest

from tiresias_tpu.api import Tiresias
from tiresias_tpu.config import (
    NOISE20_COEF_WEIGHTS,
    DspConfig,
    MatchConfig,
    TiresiasConfig,
    config_from_mapping,
)
from tiresias_tpu.ops.mfcc_jax import fingerprint_padded_batch
from tiresias_tpu.utils.audio import synth_chirp, synth_tone

SR = 8000


class TestCoefWeights:
    def test_weights_scale_log_values_per_coef(self, rng):
        """fp(weighted) == fp(parity) / w elementwise — the weighting is
        a pure change of basis on the stored value space."""
        pcm = (0.3 * rng.standard_normal((2, 4096))).astype(np.float32)
        plain = DspConfig(n_coefs=8)
        w = tuple(float(x) for x in NOISE20_COEF_WEIGHTS)
        weighted = DspConfig(n_coefs=8, coef_weights=w)
        fp_p = np.asarray(fingerprint_padded_batch(pcm, SR, plain))
        fp_w = np.asarray(fingerprint_padded_batch(pcm, SR, weighted))
        np.testing.assert_allclose(
            fp_w, fp_p / np.asarray(w, np.float32), rtol=1e-6
        )

    def test_validation(self):
        with pytest.raises(ValueError, match="entries"):
            DspConfig(n_coefs=8, coef_weights=(1.0, 2.0))
        with pytest.raises(ValueError, match="positive"):
            DspConfig(n_coefs=2, coef_weights=(1.0, -1.0))
        assert DspConfig(n_coefs=2, coef_weights=(1, 2)).coef_weights == (
            1.0, 2.0,
        )

    def test_ini_parses_weights_and_margin(self):
        cfg = config_from_mapping({
            "global": {
                "n_coefs": "8",
                "coef_weights": "noise20",
                "min_margin": "0.2",
            },
        })
        assert cfg.dsp.coef_weights == NOISE20_COEF_WEIGHTS
        assert cfg.match.min_margin == 0.2
        cfg2 = config_from_mapping({
            "global": {"n_coefs": "2", "coef_weights": "1.5, 0.5"},
        })
        assert cfg2.dsp.coef_weights == (1.5, 0.5)

    def test_self_match_in_weighted_space(self, tmp_path):
        """End-to-end: ingest + search both live in the weighted space,
        so exact self-match holds exactly as in parity space."""
        cfg = TiresiasConfig(
            dsp=DspConfig(n_coefs=8, coef_weights=NOISE20_COEF_WEIGHTS),
            data_dir=str(tmp_path),
        )
        eng = Tiresias(cfg, restore=False)
        eng.create_context("c")
        for i in range(6):
            eng.add_audio_pcm(
                "c", f"t{i}", synth_chirp(200 + 90 * i, 900, 1.0, SR), SR
            )
        r = eng.search_pcm(
            "c", synth_chirp(380, 900, 1.0, SR), SR,
            coefs=8, tolerance=0.05, trunc_coef1=False, aligned=True,
        )
        assert r.found and r.name == "t2"
        assert r.match_count == r.frame_count
        eng.close()

    def test_checkpoint_rejects_weight_mismatch(self, tmp_path):
        """Stored fingerprints live in the weighted space: a restore
        under different weights must fail loudly, not serve stale
        values."""
        from tiresias_tpu.store.fingerprint_store import (
            CheckpointIncompatible,
        )

        w_cfg = TiresiasConfig(
            dsp=DspConfig(n_coefs=8, coef_weights=NOISE20_COEF_WEIGHTS),
            data_dir=str(tmp_path),
        )
        eng = Tiresias(w_cfg, restore=False)
        eng.create_context("c")
        eng.add_audio_pcm("c", "t", synth_tone(440, 0.5, SR), SR)
        eng.close()  # checkpoints
        plain = TiresiasConfig(
            dsp=DspConfig(n_coefs=8), data_dir=str(tmp_path)
        )
        with pytest.raises(CheckpointIncompatible, match="coef_weights"):
            Tiresias(plain)
        # same weights restore fine
        eng2 = Tiresias(w_cfg)
        assert len(eng2.get_audios("c")) == 1
        eng2.close()


class TestMinMargin:
    def _engine(self, tmp_path, **match_kw):
        eng = Tiresias(
            TiresiasConfig(
                dsp=DspConfig(n_coefs=8),
                match=MatchConfig(**match_kw),
                data_dir=str(tmp_path),
            ),
            restore=False,
        )
        eng.create_context("c")
        return eng

    def test_wide_margin_accepts_tight_margin_rejects(self, tmp_path, rng):
        """A near-duplicate pair leaves no margin: the gate must reject;
        a clearly-unique winner passes the same gate."""
        # two near-identical stored tones -> no margin; a unique
        # chirp -> full margin
        eng = self._engine(tmp_path / "p")
        tone = synth_tone(440, 1.0, SR)
        eng.add_audio_pcm("c", "dupA", tone, SR)
        eng.add_audio_pcm("c", "dupB", tone * 0.9999, SR)
        eng.add_audio_pcm("c", "solo", synth_chirp(200, 900, 1.0, SR), SR)
        kw = dict(coefs=8, tolerance=0.1, trunc_coef1=False, aligned=True)
        r = eng.search_pcm("c", tone, SR, min_margin=0.2, **kw)
        assert r.status == "NOTFOUND"  # duplicate pair ties
        r2 = eng.search_pcm("c", tone, SR, min_margin=0.0, **kw)
        assert r2.found  # no gate: the tie resolves by insertion order
        r3 = eng.search_pcm(
            "c", synth_chirp(200, 900, 1.0, SR), SR, min_margin=0.2, **kw
        )
        assert r3.found and r3.name == "solo"
        eng.close()

    def test_config_default_applies(self, tmp_path):
        eng = self._engine(
            tmp_path, coefs=8, tolerance=0.1, trunc_coef1=False,
            aligned=True, min_margin=0.5,
        )
        tone = synth_tone(440, 1.0, SR)
        eng.add_audio_pcm("c", "dupA", tone, SR)
        eng.add_audio_pcm("c", "dupB", tone * 0.9999, SR)
        r = eng.search_pcm("c", tone, SR)
        assert r.status == "NOTFOUND"  # config gate applied
        r2 = eng.search_pcm("c", tone, SR, min_margin=0)  # explicit off
        assert r2.found
        eng.close()


class TestFusedMarginPath:
    def test_fused_and_host_margin_paths_agree(self, tmp_path,
                                               monkeypatch):
        """min_margin routed through the one-dispatch fused strict path
        must answer exactly like the host-ranked margin path —
        acceptance and rejection."""
        # LOCAL rng, not the session fixture: the margin assertions are
        # data-marginal (a random clustered row landing near the tone
        # changes the gate's decision), so the corpus must not depend on
        # how much rng state earlier tests consumed
        rng = np.random.default_rng(11)

        eng = Tiresias(
            TiresiasConfig(dsp=DspConfig(n_coefs=2),
                           data_dir=str(tmp_path)),
            restore=False,
        )
        eng.create_context("c")
        # clustered corpus big enough for the prefilter gate, placed in
        # a value range far BELOW real audio (the margin assertions are
        # about the dup pair and the solo clip, not a random distractor
        # that happens to land near the tone)
        mu = rng.uniform(-110, -60, (2200, 1, 2)).astype(np.float32)
        fps = (mu + 0.5 * rng.standard_normal((2200, 48, 2))).astype(
            np.float32
        )
        for i in range(2200):
            eng.store.add_audio(f"t{i}", "c", fps[i], f"h{i:06d}")
        tone = synth_tone(440, 1.0, SR)
        chirp = synth_chirp(200, 900, 1.0, SR)
        eng.add_audio_pcm("c", "dupA", tone, SR)
        eng.add_audio_pcm("c", "dupB", tone * 0.9999, SR)
        eng.add_audio_pcm("c", "solo", chirp, SR)
        kw = dict(coefs=2, tolerance=0.1, trunc_coef1=False,
                  min_margin=0.2)

        orig = eng._fused_strict_batch

        def run_both(q):
            calls = {"n": 0}

            def spy(*a, **k):
                out = orig(*a, **k)
                if out is not None:
                    calls["n"] += 1
                return out

            monkeypatch.setattr(eng, "_fused_strict_batch", spy)
            fused = eng.search_pcm("c", q, SR, **kw)
            assert calls["n"] == 1, "fused margin path not taken"
            monkeypatch.setattr(eng, "_fused_strict_batch",
                                lambda *a, **k: None)
            host = eng.search_pcm("c", q, SR, **kw)
            return fused, host

        f1, h1 = run_both(tone)  # duplicate pair: margin rejects
        assert f1.status == h1.status == "NOTFOUND"
        f2, h2 = run_both(chirp)  # unique winner: accepted
        assert f2.found and h2.found
        assert f2.name == h2.name == "solo"
        assert f2.match_count == h2.match_count
        eng.close()
