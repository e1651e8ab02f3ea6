"""The pretraining CLI on its mesh flags (CPU, ``python -m
torch.distributed.run`` over 2 gloo ranks), which no JAX test covers:
``pretrain --smoke --n_experts 4 --experts_parallel 2`` and ``pretrain
--smoke --model_parallel 2`` (``final_proj`` column-parallel with its
output gathered, the codebook split over its 8 classes), held as
``tests/test_torch_avhubert_mesh_cli.py`` holds the fine-tuning CLI:
``mesh`` and ``sharded_params`` against JAX's ``main``, the losses and
accuracies (fp32) within 1e-5 relative of the port's one-process run.
Both run two HuBERT iterations: each rebuilds and re-shards the state, and
the second trains on k-means targets of the first model's layer-1
features, which every rank taps whole, so its losses match one process's
only if every rank fitted one process's targets.
"""

import pytest

from test_torch_avhubert_mesh_cli import check_cli_on_mesh
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)

CASES = {
    "pretrain_ep": ["--n_experts", "4", "--experts_parallel", "2", "--iterations", "2"],
    "pretrain_tp": ["--model_parallel", "2", "--iterations", "2"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_torch_pretrain_cli_mesh_flags_match_jax_and_one_process(tmp_path, case):
    check_cli_on_mesh(tmp_path, case, "pretrain", CASES[case])
