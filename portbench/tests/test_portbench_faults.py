"""A run with the timed path broken underneath comes out not correct: at
a tiny size on the CPU, every fault a cell can have (one card: no
exchange between cards to leave out), and the control, the reference at
fp8 in the program's place."""

import pytest

from .conftest import run_cell


@pytest.mark.parametrize("workload,fault", [
    ("tiny.finetune", "unchanged_state"),
    ("tiny.finetune", "half_batch"),
    ("tiny.finetune_avhubert", "unchanged_state"),
    ("tiny.finetune_avhubert", "half_batch"),
    ("tiny.transcribe", "altered_token"),
    ("tiny.finetune", "fp8"),
    ("tiny.finetune_avhubert", "fp8"),
    ("tiny.transcribe", "fp8"),
])
def test_portbench_fault_is_caught(workload, fault):
    rc, line, err = run_cell(workload, seed=2 ** 31 + 777, control=fault)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]
