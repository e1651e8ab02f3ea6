"""``spanrun.py`` at a tiny size on the CPU: run.py's line unchanged, then
the readings the program's spans and upload counter give without a device
trace (the idle shares need the card's)."""

import json
import os
import subprocess
import sys

import pytest

from .conftest import ROOT, TINY

READ = {"transcribe": {"host_prepare_ms.transcribe", "upload_mb_per_seg.transcribe",
                       "decode_step_ms.transcribe"},
        "train": {"host_collate_ms.train", "upload_mb_per_seg.train", "optimizer_ms.train"}}


@pytest.mark.parametrize("workload", ["tiny.transcribe", "tiny.finetune",
                                      "tiny.finetune_avhubert"])
def test_portbench_spanrun_reads_spans_on_the_cpu(workload):
    cmd = [sys.executable, str(ROOT / "portbench" / "spanrun.py"), "--workload", workload,
           "--seed", str(2 ** 31 + 99), "--seconds", "1", "--device", "cpu",
           "--benchmark", str(TINY / "BENCHMARK.json"), "--files", str(TINY)]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, env=env, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    first, second = [json.loads(l) for l in proc.stdout.splitlines() if l.strip()][-2:]
    assert first["correct"] is True and first["failed"] == 0
    kind = "transcribe" if "transcribe" in workload else "train"
    assert set(second["spans"]) == READ[kind]
    assert all(v["value"] > 0 for v in second["spans"].values())
    assert second["idle_by_span"] is None  # no device trace on the CPU
    if kind == "transcribe":
        # 16,000 samples of PCM and 25 lip frames of 88 x 88, fp32, a row
        mb = second["spans"]["upload_mb_per_seg.transcribe"]["value"]
        assert mb == pytest.approx((16000 + 25 * 88 * 88) * 4 / 1e6)
