"""A whole run of each kind at a tiny size on the CPU (the kernels' plain
versions), and the checks that keep JAX and the JAX package out."""

import ast
import sys
from pathlib import Path

import pytest

from .conftest import ROOT, run_cell

PORTBENCH = ROOT / "portbench"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("workload", ["tiny.transcribe", "tiny.finetune",
                                      "tiny.finetune_avhubert"])
def test_portbench_tiny_run_end_to_end_on_the_cpu(workload):
    rc, line, err = run_cell(workload, seed=2 ** 31 + 12345)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    rate = "transcribe_segments_per_s" if "transcribe" in workload else "train_segments_per_s"
    assert set(line["metrics"]) == {rate, "peak_mem_gb", "setup_s"}
    assert "loaded" not in err


def test_portbench_no_card_no_result():
    rc, line, err = run_cell("flamingo_large.transcribe_b64_t8", seed=1, tiny=False,
                             device="cuda")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert rc != 0 and line is None and "CUDA" in err


def test_portbench_forbidden_modules_compare_whole_names(monkeypatch):
    sys.path.insert(0, str(PORTBENCH))
    try:
        import run  # portbench/run.py as a script imports it
    finally:
        sys.path.remove(str(PORTBENCH))
    fake = {"avsl_tpu_torch": None, "avsl_tpu_torch.models": None, "numpy": None}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", dict(fake, **{"avsl_tpu.core": None, "jax": None}))
    assert run.forbidden_modules() == ["avsl_tpu", "jax"]


def test_portbench_sources_import_neither_jax_nor_the_jax_package():
    for path in PORTBENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "avsl_tpu"), (path, name)


def test_portbench_reference_imports_nothing_of_the_program():
    for path in (PORTBENCH / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] != "avsl_tpu_torch", (path, name)
            if name.startswith("portbench"):
                assert name.startswith("portbench.reference"), (path, name)


def test_portbench_short_transcribe_result_counts_as_failed(monkeypatch):
    from types import SimpleNamespace

    import numpy as np

    from portbench import registry

    from .conftest import TINY

    monkeypatch.setitem(registry.SOURCES, "files", TINY)
    driver = registry.driver("transcribe")
    traffic = registry.traffic("tiny_transcribe")
    ctx = SimpleNamespace(traffic=traffic, cfg=registry.config("tiny_flamingo"), seed=2 ** 31 + 5,
                          control=None)

    class Short:
        """Returns every item's result but the last, and one under a wrong id."""

        def transcribe(self, items):
            out = [SimpleNamespace(id=it["id"], tokens=[1, 2], avg_logprob=-1.0)
                   for it in items[:-1]]
            out[0].id = "wrong"
            return out

    n = traffic["pool"]
    st = driver.State(ctx, transcriber=Short(), prompt=[0],
                      audio=np.zeros((n, 16), np.float32), has_video=np.zeros(n, bool))
    win = driver.window(st, 0.0)
    assert win["attempted"] == traffic["batch_size"] * traffic["batches_per_call"]
    assert win["failed"] == 2 and len(st.served) == win["attempted"] - 2


def test_portbench_failed_rows_are_those_of_non_finite_losses():
    import torch

    from portbench import steps

    ran = [(torch.tensor(1.5), 8), (torch.tensor(float("nan")), 8), (torch.tensor(float("inf")), 4)]
    assert steps.failed_rows(ran) == 12
    assert steps.failed_rows(ran[:1]) == 0 and steps.failed_rows([]) == 0


def test_portbench_without_the_program_gives_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    own folder, a run exits non-zero and prints no result."""
    import json
    import os
    import shutil
    import subprocess

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    tiny = tmp_path / "portbench" / "tests" / "tiny"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "tiny.transcribe", "--seed", "7",
         "--seconds", "1", "--trace", "0", "--device", "cpu",
         "--benchmark", str(tiny / "BENCHMARK.json"), "--files", str(tiny)],
        cwd=tmp_path, capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
