"""tools/kernel_race.py's plumbing at toy size on the CPU (``--tiny``):
every race pairs the fused matcher with the XLA form and reports equal
votes, and the engine race forces the XLA form and back without changing
an answer. The timings mean nothing here; the tool's GPU run makes them.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_tiny_races_agree():
    proc = subprocess.run(
        [sys.executable, os.path.join("tools", "kernel_race.py"), "--tiny"],
        cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    results = [json.loads(ln) for ln in proc.stdout.splitlines()
               if ln.startswith("{") and '"check"' in ln]
    labels = " ".join(r["race"] for r in results)
    for part in ("bag full", "bag rescore", "aligned full",
                 "aligned rescore", "engine strict", "engine aligned"):
        assert part in labels, labels
    for r in results:
        assert r["check"]["equal"], r


def test_gpu_required_without_tiny():
    proc = subprocess.run(
        [sys.executable, os.path.join("tools", "kernel_race.py")],
        cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
