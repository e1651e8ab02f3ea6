"""The Auto-AVSR cell's pieces at a tiny size on the CPU
(``tests/tiny_avsr/``, the port's ``AutoAVSRConfig.tiny_test`` widths in
fp32): a run is correct, untraced and traced (the two readers then read
the driver's span record); the planted faults and the fp8 control are
not; ``flops_avsr.py`` on a hand-counted block; the two readers on a
synthetic window, and None where there is nothing to read."""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import flops_avsr, registry

from .conftest import ROOT

TINY_AVSR = Path(__file__).resolve().parent / "tiny_avsr"
SEED = 2 ** 31 + 4321


def _run(control=None, trace=0):
    """``run.py`` on the tiny cell: (returncode, last line or None, stderr)."""
    cmd = [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", "tiny.finetune_raw",
           "--seed", str(SEED), "--seconds", "1", "--trace", str(trace), "--device", "cpu",
           "--benchmark", str(TINY_AVSR / "BENCHMARK.json"), "--files", str(TINY_AVSR)]
    if control:
        cmd += ["--control", control]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, env=env, timeout=900)
    lines = [l for l in proc.stdout.splitlines() if l.strip()]
    return proc.returncode, (json.loads(lines[-1]) if proc.returncode == 0 and lines else None), \
        proc.stderr


@pytest.mark.parametrize("trace", [0, 1])
def test_portbench_auto_avsr_tiny_run_is_correct(trace):
    rc, line, err = _run(trace=trace)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    if trace:
        # no device trace on the CPU: the span readers alone read
        assert set(line["metrics"]) == {"conformer_host_ms.train", "relpos_mb_per_seg.train"}
        # 2 encoders x 2 blocks x 2 heads x 12 frames x (23 + 24) fp32 a row
        assert line["metrics"]["relpos_mb_per_seg.train"]["value"] == pytest.approx(0.018048)
        assert line["metrics"]["conformer_host_ms.train"]["value"] > 0
    else:
        assert set(line["metrics"]) == {"train_segments_per_s", "peak_mem_gb", "setup_s"}


@pytest.mark.parametrize("control", ["half_batch", "unchanged_state", "fp8"])
def test_portbench_auto_avsr_faults_are_caught(control):
    rc, line, err = _run(control=control)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]


def test_portbench_auto_avsr_flops_of_a_hand_counted_block():
    m = {"adim": 4, "eunits": 8, "cnn_module_kernel": 3}
    t = 5
    ffn = 2 * (2 * 5 * 4 * 8 + 2 * 5 * 8 * 4)
    qkvo = 4 * 2 * 5 * 4 * 4
    scores = 4 * 5 * 5 * 4 + 2 * 5 * 9 * 4  # (q+u)k^T and the weighted sum, (q+v)p^T
    conv = 2 * 5 * 4 * 8 + 2 * 5 * 4 * 3 + 2 * 5 * 4 * 4
    assert flops_avsr.conformer_block(m, t) == ffn + qkvo + scores + conv
    assert flops_avsr.positions(m, t) == 2 * 9 * 4 * 4
    # 640 samples: conv1 to 160 (x 8 channels x 80 taps), then blocks at 160, 80, 40, 20
    a = {"audio_backbone_channels": 64}
    stem = 2 * 160 * 8 * 80
    l1 = 2 * (2 * 160 * 8 * 8 * 3 * 2)
    l2 = 2 * 80 * 16 * 8 * 3 + 2 * 80 * 16 * 16 * 3 + 2 * 80 * 16 * 8 + 2 * 80 * 16 * 16 * 3 * 2
    l3 = 2 * 40 * 32 * 16 * 3 + 2 * 40 * 32 * 32 * 3 + 2 * 40 * 32 * 16 + 2 * 40 * 32 * 32 * 3 * 2
    l4 = 2 * 20 * 64 * 32 * 3 + 2 * 20 * 64 * 64 * 3 + 2 * 20 * 64 * 32 + 2 * 20 * 64 * 64 * 3 * 2
    assert flops_avsr.audio_resnet(a, 640 + 100) == stem + l1 + l2 + l3 + l4


def _reader(name):
    return registry.reader(name).read


def _span(name, start, end):
    return SimpleNamespace(name=name, thread=1, start_ns=start, end_ns=end, parent=-1)


def test_portbench_auto_avsr_readers_on_a_synthetic_window():
    spans = [_span("train.forward", 0, 100_000_000),
             _span("avsr.conformer", 10_000_000, 40_000_000),
             _span("train.forward", 200_000_000, 300_000_000),
             _span("avsr.conformer", 210_000_000, 260_000_000)]
    win = {"kind": "train", "segments": 32, "spans": spans,
           "counters": {"avsr.relpos_bytes": 64_000_000, "h2d_bytes": 5}}
    ctx = {"trace": object(), "window": win}
    assert _reader("conformer_host_ms.train")(ctx) == pytest.approx(40.0)  # (30 + 50) ms / 2
    assert _reader("relpos_mb_per_seg.train")(ctx) == pytest.approx(2.0)
    # nothing to read: no record (a program without spans), no span or
    # counter of its name, another kind of window, no segment
    base = {"kind": "train", "segments": 32}
    for empty in (base, dict(base, spans=[], counters={}),
                  dict(base, spans=spans[:1], counters={"h2d_bytes": 5}),
                  dict(win, kind="transcribe")):
        ctx = {"trace": object(), "window": empty}
        assert _reader("conformer_host_ms.train")(ctx) is None
        assert _reader("relpos_mb_per_seg.train")(ctx) is None
    assert _reader("relpos_mb_per_seg.train")({"trace": None, "window": dict(win, segments=0)}) \
        is None


def test_portbench_auto_avsr_window_reads_a_recording_already_open():
    from avsl_tpu_torch.utils import spans

    driver = registry.driver("finetune_auto_avsr")
    with spans.recording() as outer:
        with driver._recording(True) as rec:
            spans.count("avsr.relpos_bytes", 7)
        assert rec is outer and outer.counters == {"avsr.relpos_bytes": 7}
    with driver._recording(False) as rec:
        assert rec is None
    with driver._recording(True) as rec:
        spans.count("avsr.relpos_bytes", 3)
    assert rec.counters == {"avsr.relpos_bytes": 3}
