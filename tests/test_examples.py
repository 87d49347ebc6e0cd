"""The shipped examples work against a live engine/server.

examples/agi_tiresias.py reproduces the reference's dialplan contract
(/root/reference/src/application_handler.c) over EAGI + the TCP service;
its protocol client is exercised here against a real server.
"""

import asyncio
import importlib.util
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from tiresias_tpu.api import Tiresias
from tiresias_tpu.config import MatchConfig, TiresiasConfig
from tiresias_tpu.serve.server import RecognitionServer
from tiresias_tpu.utils.audio import synth_tone

SR = 8000
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _load_example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    eng = Tiresias(
        TiresiasConfig(
            match=MatchConfig(coefs=2, tolerance=0.01, trunc_coef1=False),
            data_dir=str(tmp_path_factory.mktemp("agi")),
        ),
        restore=False,
    )
    eng.create_context("media")
    pcm = synth_tone(500, 2.0, SR)
    i16 = np.clip(np.round(pcm * 32768.0), -32768, 32767).astype(np.int16)
    eng.add_audio_pcm("media", "tone500", i16.astype(np.float32) / 32768.0, SR)
    return eng


@pytest.fixture()
def server(engine):
    started = threading.Event()
    holder = {}

    def runner():
        async def main():
            srv = RecognitionServer(engine, port=0, samplerate=SR)
            await srv.start()
            holder["server"] = srv
            holder["loop"] = asyncio.get_running_loop()
            started.set()
            try:
                await srv.serve_forever()
            except asyncio.CancelledError:
                pass

        asyncio.run(main())

    thread = threading.Thread(target=runner, daemon=True)
    thread.start()
    assert started.wait(10)
    yield holder["server"]
    asyncio.run_coroutine_threadsafe(
        holder["server"].stop(), holder["loop"]
    )


class TestAgiExample:
    def test_recognize_round_trip(self, server):
        agi = _load_example("agi_tiresias")
        pcm = synth_tone(500, 1.2, SR)
        i16 = np.clip(np.round(pcm * 32768.0), -32768, 32767).astype("<i2")
        result = agi.recognize(
            "127.0.0.1", server.port, "media", i16.tobytes(),
            duration_ms=1000, tolerance=0.01, freq_lo=-1, freq_hi=-1,
        )
        assert result["TIRSTATUS"] == "FOUND"
        assert result["TIRFILENAME"] == "tone500"
        assert float(result["CONFIDENCE"]) > 0.9

    def test_agi_env_parsing(self):
        agi = _load_example("agi_tiresias")
        import io

        env = agi.agi_read_env(io.StringIO(
            "agi_request: agi_tiresias.py\nagi_channel: SIP/100-1\n\n"
        ))
        assert env["agi_channel"] == "SIP/100-1"


class TestQuickstartExample:
    def test_runs_clean(self):
        proc = subprocess.run(
            [sys.executable, os.path.join(EXAMPLES, "quickstart.py")],
            capture_output=True, text=True, timeout=300,
            env={
                **os.environ,
                "JAX_PLATFORMS": "cpu",
                # The example must import tiresias_tpu even when the package
                # is not pip-installed (script dir, not repo root, lands on
                # sys.path for a direct `python examples/quickstart.py` run).
                "PYTHONPATH": os.pathsep.join(
                    [os.path.abspath(os.path.join(EXAMPLES, ".."))]
                    + [
                        p
                        for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                        if p
                    ]
                ),
            },
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "file search: FOUND prompt2.wav" in proc.stdout
