"""Data parallelism through ``avsl_tpu_torch``: the replicated state,
ZeRO-1 and FSDP over 2 gloo ranks, against the JAX package's step on its
CPU mesh (fp32, every rate 0).

The tiny Whisper-Flamingo model is carried from JAX
(``test_torch_flamingo_common.carried_flamingo``) and trained 3
accumulated steps (2 micro-batches of 4 rows) under the Flamingo regime
with BatchNorm on the batch's statistics, so each micro-step reads the
statistics of the global batch. The two data ranks hold unequal counts
of valid labels, so only the global token mean gives JAX's loss. One
spawn runs every variant in the same 2 ranks (``torch_mesh_workers.py``;
no rank imports ``jax``); the parent computes JAX's side on
``make_mesh(2)``.

Bounds: each mesh variant against the port's single-device step, loss
and grad norm rtol 1e-6 and trained tensors atol 1e-6 (fp32 sums over
other splits of the batch); against JAX, loss and grad norm rtol 2e-5
and the running statistics atol 1e-5 (as ``test_torch_flamingo_train.py``
holds the single-device step: XLA's and PyTorch's CPU kernels sum in
other orders), trained tensors after 3 steps atol 1e-5; frozen tensors
bit-identical to where they started.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.core.config import FlamingoTrainConfig as JaxTrainConfig
from avsl_tpu.core.mesh import make_mesh as jax_make_mesh
from avsl_tpu.core.partitioning import shard_state as jax_shard_state
from avsl_tpu.train import TrainState as JaxTrainState
from avsl_tpu.train import make_train_step as jax_make_train_step
from avsl_tpu.train.objectives import flamingo_loss_fn as jax_loss_fn
from avsl_tpu.train.optim import select_optimizer as jax_select_optimizer
from avsl_tpu_torch.models import state_dict_from_flax
from test_torch_flamingo_common import carried_flamingo, one_torch_thread  # noqa: F401
from test_torch_flamingo_loss import make_batch
from torch_mesh_workers import MIXING, TRAIN_CFG, dp_ranks, eval_flamingo, spawn, train_flamingo

LOSS_RTOL_MESH, PARAM_ATOL_MESH = 1e-6, 1e-6
LOSS_RTOL_JAX, PARAM_ATOL_JAX, STATS_ATOL_JAX = 2e-5, 1e-5, 1e-5


def uneven_batches(cfg, seed=6, n=3, lead=(2, 4)):
    """``n`` global [accum, micro] batches whose first half of each
    micro-batch (data rank 0's rows) keeps 4 labels and second half 1."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n):
        b = make_batch(cfg, rng, lead=lead)
        b["labels"][..., lead[-1] // 2:, 1:] = -100
        batches.append(b)
    return batches


def jax_reference(jmodel, variables, batches, n_devices=2, model_parallel=1, accum=2):
    """JAX's step on ``make_mesh(n_devices, model_parallel)`` (the rule
    layout when ``model_parallel`` > 1): per-step loss and grad norm, the
    params and the running statistics after the last step."""
    tx, jlabels = jax_select_optimizer(variables["params"], JaxTrainConfig(**TRAIN_CFG), 20)
    mesh = jax_make_mesh(n_devices, model_parallel=model_parallel)
    state = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, variables["params"]), tx,
                                 batch_stats=variables["batch_stats"])
    partitioned = model_parallel > 1
    if partitioned:
        state = jax_shard_state(state, mesh)
    else:
        state = jax.device_put(state, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    step = jax_make_train_step(jax_loss_fn(jmodel, train=True, **MIXING), tx, mesh=mesh,
                               grad_accum_steps=accum, donate=False, param_labels=jlabels,
                               partitioned_state=partitioned)
    losses, norms = [], []
    for batch in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"loss": losses, "grad_norm": norms,
            "params": state_dict_from_flax(jax.device_get(state.params)),
            "stats": state_dict_from_flax({}, jax.device_get(state.batch_stats))}


def assert_run_close(got, want, loss_rtol, param_atol):
    """A port run against another (``want`` from ``train_flamingo``)."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=loss_rtol)
    for name, w in want["trained"].items():
        np.testing.assert_allclose(got["trained"][name], w, atol=param_atol, rtol=0, err_msg=name)
    for name, w in want["frozen"].items():
        np.testing.assert_array_equal(got["frozen"][name], w, err_msg=name)


def assert_matches_jax(got, want, initial):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL_JAX)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=LOSS_RTOL_JAX)
    assert len(got["trained"]) > 20
    for name, t in got["trained"].items():
        np.testing.assert_allclose(t, want["params"][name].numpy(), atol=PARAM_ATOL_JAX, rtol=0,
                                   err_msg=name)
    for name, t in got["frozen"].items():
        np.testing.assert_array_equal(t, initial[name].numpy(), err_msg=name)
    for name, s in got["stats"].items():
        np.testing.assert_allclose(s, want["stats"][name].numpy(), atol=STATS_ATOL_JAX, rtol=0,
                                   err_msg=name)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    jmodel, variables, port, cfg = carried_flamingo()
    path = str(tmp / "state.pt")
    torch.save(port.state_dict(), path)
    batches = uneven_batches(cfg)
    three_row = make_batch(cfg, np.random.default_rng(9), lead=(3,))
    ranks = spawn(dp_ranks, 2, tmp, path, batches, three_row)
    return {
        "ranks": ranks,
        "single": train_flamingo(path, batches, None),
        "three_single": train_flamingo(path, [three_row], None, accum=1),
        "eval_single": eval_flamingo(path, batches[0]),
        "jax": jax_reference(jmodel, variables, batches),
        "initial": {k: v.clone() for k, v in port.state_dict().items()},
    }


@pytest.mark.parametrize("variant", ["dp", "zero1", "fsdp"])
def test_torch_dp_step_matches_single_device_and_jax(runs, variant):
    """dp 2 replicated, ZeRO-1 and FSDP: the single-device step on the
    global batch (unequal label counts per rank) and JAX's mesh step."""
    for rank in (0, 1):
        got = runs["ranks"][rank][variant]
        assert_run_close(got, runs["single"], LOSS_RTOL_MESH, PARAM_ATOL_MESH)
        assert_matches_jax(got, runs["jax"], runs["initial"])
        for name, s in got["stats"].items():  # training BatchNorm on the global batch
            np.testing.assert_allclose(s, runs["single"]["stats"][name], atol=1e-6, rtol=0)


def test_torch_dp_ranks_hold_their_share(runs):
    """ZeRO-1 splits the moments of the large trained tensors and FSDP
    every parameter (and its moments) over the 2 data ranks."""
    r0 = runs["ranks"][0]
    full = r0["dp"]["bytes"]
    assert r0["zero1"]["bytes"] < full
    assert abs(r0["fsdp"]["bytes"] - full / 2) < 0.01 * full
    assert runs["ranks"][1]["fsdp"]["bytes"] < 0.51 * full


def test_torch_dp_partial_batch_is_given_whole(runs):
    """3 rows on 2 data ranks: every rank takes the whole batch and the
    step is the single-device one (the loss is not counted twice)."""
    for rank in (0, 1):
        assert_run_close(runs["ranks"][rank]["three"], runs["three_single"],
                         LOSS_RTOL_MESH, PARAM_ATOL_MESH)


def test_torch_dp_eval_step_is_the_global_token_mean(runs):
    """``make_eval_step(mesh=)`` on 2 data ranks holding unequal label
    counts: every rank reports the single-device loss."""
    for rank in (0, 1):
        np.testing.assert_allclose(runs["ranks"][rank]["eval"], runs["eval_single"],
                                   rtol=LOSS_RTOL_MESH)


def test_torch_dp_runner_fsdp_end_to_end(runs):
    """``TrainerRunner(fsdp=True)`` on a mesh: its parameters are DTensors
    and its losses track the replicated runner's."""
    for rank in (0, 1):
        rep, fsdp = runs["ranks"][rank]["runner"][False], runs["ranks"][rank]["runner"][True]
        np.testing.assert_allclose(fsdp[0], rep[0], rtol=LOSS_RTOL_MESH)
        assert fsdp[1] and fsdp[2] and fsdp[3] == "DTensor"
        assert not rep[1] and not rep[2] and rep[3] == "Parameter"
        np.testing.assert_allclose(rep[0], runs["single"]["loss"][:2], rtol=LOSS_RTOL_MESH)
