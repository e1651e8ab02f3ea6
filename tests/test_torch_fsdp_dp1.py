"""FSDP at a data axis of 1 through ``avsl_tpu_torch``: JAX's
``state_shardings(fsdp=True)`` puts a data axis of size 1 on the large
leaves, which splits nothing (``avsl_tpu/core/partitioning.py:146-150``),
so the port's ``shard_state(fsdp=True)`` on such a mesh calls no
``fully_shard`` and its step is the no-mesh one.

On one gloo rank the tiny Whisper-Flamingo (carried from JAX) trains 3
accumulated steps with FSDP at dp 1 and without a mesh: losses, grad
norms and trained tensors bit-equal, every parameter a plain tensor, and
``Layout.fsdp`` False. FSDP2 on that mesh was not bit-equal: its hooks on
each unit's inputs summed the gradient of the projected video, which every
decoder block reads, in another order. FSDP2 at dp 2 stays held to one
device in ``test_torch_dp_train.py``.
"""

import numpy as np
import torch

from test_torch_dp_train import uneven_batches
from test_torch_flamingo_common import carried_flamingo, one_torch_thread  # noqa: F401
from torch_mesh_workers import fsdp_dp1_ranks, spawn


def test_torch_fsdp_at_dp1_is_the_no_mesh_step(tmp_path):
    _, _, port, cfg = carried_flamingo()
    path = str(tmp_path / "state.pt")
    torch.save(port.state_dict(), path)
    out = spawn(fsdp_dp1_ranks, 1, tmp_path, path, uneven_batches(cfg))[0]
    assert out["fsdp"]["loss"] == out["none"]["loss"]
    assert out["fsdp"]["grad_norm"] == out["none"]["grad_norm"]
    for n, want in out["none"]["trained"].items():
        np.testing.assert_array_equal(out["fsdp"]["trained"][n], want)
    assert out["layout_fsdp"] is False and out["param_types"] == ["Parameter"]
