"""LoRA over FSDP and over tensor parallelism (CPU, gloo ranks).

JAX's LoRA step (``avsl_tpu/cli/finetune.py:204-235``) holds the base as
a frozen closure constant, replicated on every device, and its state is
the adapters alone, whose paths (``.../kernel/lora_a``) match no
partitioning rule: under FSDP the adapters of ``ZERO1_MIN_ELEMS`` elements
or more split over the data axis, and under tensor parallelism nothing
splits while sequence parallelism stays on. The carried tiny
Whisper-Flamingo under ``cli/finetune.py``'s LoRA (rank 4 on the query
and value projections, ``lora_optimizer``, the Flamingo loss with the
AV-mode mixing), 3 steps of 2 micro-batches with unequal label counts per
data rank, at dp 2 under FSDP (``ZERO1_MIN_ELEMS`` lowered to 256, so the
[64, 4] adapters' moments split and the [4, 64] ones' too, while the
frozen base is never ``fully_shard``-ed) and at dp 1 x mp 2 (the encoders'
activations split over T): losses within 1e-6 relative and the trained
adapters within 1e-6 of one process.
"""

import numpy as np
import pytest
import torch

from test_torch_dp_train import uneven_batches
from test_torch_flamingo_common import carried_flamingo, one_torch_thread  # noqa: F401
from torch_mesh_workers import lora_ranks, spawn, train_lora

TOL = dict(rtol=1e-6, atol=1e-6)
MIN_ELEMS = 256


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lora_mesh")
    _, _, port, cfg = carried_flamingo()
    path = str(tmp / "state.pt")
    torch.save(port.state_dict(), path)
    batches = uneven_batches(cfg)
    variants = [("fsdp_dp2", dict(n=2, fsdp=True)), ("mp2", dict(n=2, mp=2))]
    return {"ranks": spawn(lora_ranks, 2, tmp, path, batches, variants, MIN_ELEMS),
            "single": train_lora(path, batches, None, MIN_ELEMS)}


@pytest.mark.parametrize("variant", ["fsdp_dp2", "mp2"])
def test_torch_lora_on_a_mesh_matches_one_process(runs, variant):
    single = runs["single"]
    for rank, out in enumerate(runs["ranks"]):
        got = out[variant]
        np.testing.assert_allclose(got["loss"], single["loss"], **TOL, err_msg=f"rank {rank}")
        assert sorted(got["adapters"]) == sorted(single["adapters"])
        for name, want in single["adapters"].items():
            np.testing.assert_allclose(got["adapters"][name], want, **TOL,
                                       err_msg=f"{variant} rank {rank} {name}")
        # the adapters trained (lora_b starts at zero)
        assert any(np.abs(w).max() > 0 for n, w in got["adapters"].items() if "lora_b" in n)
        assert got["fsdp"] is False  # the frozen base is a constant: no fully_shard
        if variant == "fsdp_dp2":  # JAX's data-axis split of the adapters' moments
            for name, shape in got["mu_shapes"].items():
                full = single["mu_shapes"][name]
                assert shape == ((full[0] // 2,) + full[1:] if np.prod(full) >= MIN_ELEMS
                                 else full), (name, shape, full)
            assert got["splits"] == 0
        else:  # nothing splits over the model axis, but sequence parallelism is on
            assert got["mu_shapes"] == single["mu_shapes"]
            assert got["splits"] > 0 and single["splits"] == 0
