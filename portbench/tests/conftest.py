"""Fixtures of the benchmark's own tests. Whether a card is there is
decided inside the ``card`` fixture, when a test asks for it, never while
a module is imported."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
TINY = Path(__file__).resolve().parent / "tiny"


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the cell at its own size on the chip")
    return "cuda"


def run_cell(workload, seed, seconds=1.0, control=None, tiny=True, device="cpu", trace=0):
    """``portbench/run.py`` in a subprocess: (returncode, last stdout line
    parsed or None, stderr)."""
    import json

    cmd = [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace),
           "--device", device]
    if tiny:
        cmd += ["--benchmark", str(TINY / "BENCHMARK.json"), "--files", str(TINY)]
    if control:
        cmd += ["--control", control]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, env=env, timeout=900)
    lines = [l for l in proc.stdout.splitlines() if l.strip()]
    line = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return proc.returncode, line, proc.stderr
