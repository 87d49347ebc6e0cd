"""chip_smoke.py on the CPU: its refusals, and every phase at toy size.

The script's own run needs a GPU; here each phase function is called
directly with small sizes (the kernel phase runs the Triton kernels in the
Pallas interpreter), so a change that breaks a phase's control flow or its
parity checks fails here first.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")

sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402


def _run(cwd, *args, timeout=300):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=timeout,
    )


def _ok_line(stdout: str) -> bool:
    return any(
        ln.startswith("{") and json.loads(ln).get("ok") is True
        and "device" in json.loads(ln)
        for ln in stdout.splitlines()
    )


class TestRefusals:
    def test_refuses_a_cpu_device(self):
        proc = _run(REPO)
        assert proc.returncode != 0
        assert not _ok_line(proc.stdout)
        assert "no GPU" in proc.stderr

    def test_refuses_without_the_repo(self, tmp_path):
        shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
        proc = _run(str(tmp_path))
        assert proc.returncode != 0
        assert not _ok_line(proc.stdout)

    def test_card_info_without_nvidia_smi(self, monkeypatch):
        monkeypatch.setenv("PATH", "")
        info = cs.card_info()
        assert info["card"] == "not available"
        assert info["power_limit"] == "not available"


@pytest.fixture(scope="module")
def dialplan_state():
    state: dict = {}
    result = cs.phase_dialplan(n_clips=600, n_queries=4, n_oracle=2,
                               sub_rows=48, keep=state)
    yield result, state
    state["engine"].close()


class TestPhases:
    def test_fingerprint_phase(self):
        r = cs.phase_fingerprint(batch=3, samples=8192, n_ref=2,
                                 law_samples=4096)
        assert r["ok"], r
        assert r["shape_ok"] and r["finite"]
        assert r["worst_excess"] < r["excess_tol"]
        # goldens (7 cases) + f32, int16 and µ-law per reference clip
        assert r["n_checks"] == 7 + 3 * 2

    def test_dialplan_phase(self, dialplan_state):
        r, state = dialplan_state
        assert r["ok"], r
        assert r["pf_equal"]
        assert all(o["equal"] for o in r["oracle"])
        assert r["sizes"]["clips"] == 600
        assert len(state["excerpts"]) == 4

    def test_strict_phase(self, dialplan_state):
        _, state = dialplan_state
        r = cs.phase_strict(state["engine"], state["excerpts"],
                            state["truth"], n_oracle=2, sub_rows=48)
        assert r["ok"], r
        assert r["fused_program_calls"] == 4

    def test_server_phase(self, dialplan_state):
        _, state = dialplan_state
        r = cs.phase_server(state["engine"], state["excerpts"], n_clients=4)
        assert r["ok"], r
        assert r["mismatches"] == []

    def test_aligned_phase(self):
        r = cs.phase_aligned(n_clips=80, n_queries=3,
                             matrix=(2100, 128, 8))
        assert r["ok"], r
        assert r["matrix"]["certified"] > 0
        assert r["matrix"]["equal_where_certified"]

    def test_kernels_phase_interpreted(self, dialplan_state):
        _, state = dialplan_state
        db = state["engine"].store.search_views()[0].db
        r = cs.phase_kernels(bag_db=db, n_q=2, aligned_shape=(40, 128, 8),
                             interpret=True)
        assert r["ok"], r
        assert r["bag"]["equal"] and r["aligned"]["equal"]
        assert "memory_analysis" in r["bag"]

    def test_four_phase_on_virtual_devices(self):
        import jax

        if len(jax.local_devices()) < 4:
            pytest.skip("needs 4 virtual devices (tests/conftest.py)")
        r = cs.phase_four(n_clips=96, n_queries=3)
        assert r["ok"], r
        assert r["mesh"]["db"] == len(jax.local_devices())
        assert set(r["configs"]) == {"dialplan", "strict", "aligned"}


class TestCompileCache:
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise one fixed
    directory inside the checkout."""

    CODE = (
        "import jax\n"
        "from tiresias_tpu.utils.compile_cache import "
        "enable_compilation_cache, DEFAULT_DIR\n"
        "enable_compilation_cache()\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
        "print(DEFAULT_DIR)\n"
    )

    def _probe(self, env_extra):
        env = {k: v for k, v in os.environ.items()
               if k not in ("JAX_COMPILATION_CACHE_DIR",
                            "TIRESIAS_NO_COMPILE_CACHE")}
        env.update(env_extra, JAX_PLATFORMS="cpu")
        proc = subprocess.run(
            [sys.executable, "-c", self.CODE], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 0, proc.stderr
        return proc.stdout.split()

    def test_env_dir_is_used(self, tmp_path):
        used, _ = self._probe(
            {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cc")}
        )
        assert used == str(tmp_path / "cc")

    def test_default_is_inside_the_checkout(self):
        used, default = self._probe({})
        assert used == default == os.path.join(REPO, ".jax_cache")

    def test_default_dir_is_gitignored(self):
        with open(os.path.join(REPO, ".gitignore")) as fh:
            lines = {ln.strip() for ln in fh}
        assert ".jax_cache/" in lines and ".jax_cache_cold/" in lines


def test_bench_section_refuses_cpu(monkeypatch, capsys):
    """A bench section run needs a GPU: on the CPU it fails instead of
    measuring elsewhere."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_cpu_refusal", os.path.join(REPO, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    monkeypatch.setattr(sys, "argv", ["bench.py", "--section", "search"])
    assert bench.main() == 1
    assert "needs a GPU" in capsys.readouterr().err


def test_phase_failure_exits_nonzero(capsys):
    """A phase whose parity check fails stops the script with rc 1."""
    with pytest.raises(SystemExit) as exc:
        cs._run({"phase": "demo", "ok": False})
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert json.loads(out.splitlines()[-1])["phase"] == "demo"


def test_keys_compare_whole_results():
    from tiresias_tpu.api.engine import SearchResult

    a = SearchResult("FOUND", 10, 7, name="x")
    b = SearchResult("FOUND", 10, 6, name="x")
    assert cs._keys([a]) != cs._keys([b])
    assert cs._keys([a]) == cs._keys([SearchResult("FOUND", 10, 7, name="x")])
    assert np.asarray(cs._keys([a]), dtype=object).shape == (1, 4)
