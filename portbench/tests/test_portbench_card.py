"""On the card: each cell's control (the precision below the configured
one, in the program's place) and each planted fault, at the cell's own
size, on three seeds, comes out not correct. Run on a machine with the
card: ``python -m pytest portbench/tests/test_portbench_card.py``; the
tests skip without one."""

import pytest

from .conftest import run_cell

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)
CASES = [
    ("flamingo_large.finetune_b8x2", "fp8"),
    ("flamingo_large.finetune_b8x2", "half_batch"),
    ("flamingo_large.transcribe_b64_t32", "fp8"),
    ("avhubert_large.finetune_b8", "fp8"),
    ("avhubert_large.finetune_b8", "half_batch"),
    ("flamingo_large.transcribe_b64_t8", "fp8"),
]


@pytest.mark.card
@pytest.mark.parametrize("workload,control", CASES)
def test_portbench_card_control_is_not_correct(card, workload, control):
    for seed in SEEDS:
        rc, line, err = run_cell(workload, seed, seconds=5.0, control=control, tiny=False,
                                 device=card)
        assert rc == 0, err[-3000:]
        assert line["correct"] is False, (seed, line["checks"])
