"""The frozen-tower hoist against the JAX package (CPU, fp32).

With ``freeze_video_bn_stats`` (BatchNorm on the running statistics) the
Flamingo regime's towers are frozen and forward-only, so the train step
may run them once a step over the stacked batch (``precompute_fn``)
instead of once a micro-step. Three accumulated steps (2 micro-batches of
2) of the JAX hoisted step (``split_precompute=True``, as its runner
builds it) are held against the port's hoisted step, which runs the
precompute inside the step, and against the port's in-scan step with the
same frozen BatchNorm: loss and grad_norm per step rtol 2e-5, trained
parameters after 3 steps atol 1e-5, frozen parameters and the running
statistics bit-identical to where they started. The hoisted step runs the
video tower once a step, the in-scan step once a micro-step.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.train import make_train_step as jax_make_train_step
from avsl_tpu.train.objectives import flamingo_loss_fn as jax_loss_fn
from avsl_tpu.train.objectives import flamingo_tower_precompute as jax_precompute
from avsl_tpu_torch.core.config import FlamingoTrainConfig
from avsl_tpu_torch.train import TrainState, flamingo_loss_fn, make_train_step, select_optimizer
from avsl_tpu_torch.train.objectives import flamingo_tower_precompute
from test_torch_flamingo_common import one_torch_thread, port_batch_stats  # noqa: F401
from test_torch_flamingo_train import (
    MIXING,
    TRAIN_CFG,
    assert_params_close,
    flamingo_setup,
    trained_and_frozen,
)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX hoisted run: (per-step metrics, final params), and the setup."""
    jmodel, jstate, jlabels, tx, port, _, _, cfg, batches = flamingo_setup()
    step, pre = jax_make_train_step(
        jax_loss_fn(jmodel, train=True, freeze_video_bn_stats=True, **MIXING), tx,
        grad_accum_steps=2, donate=False, param_labels=jlabels,
        precompute_fn=jax_precompute(jmodel, train=True, freeze_video_bn_stats=True, **MIXING),
        split_precompute=True)
    metrics = []
    for batch in batches:
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        jstate, m = step(jstate, b, pre(jstate, b))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jstate, port, batches


def _port_step(port, mode):
    """The port's step over ``port`` in ``mode``: "fused" (the towers
    hoisted) or "in_scan" (towers in the loop), BatchNorm frozen in both."""
    opt, labels = select_optimizer(port, FlamingoTrainConfig(**TRAIN_CFG), 20)
    loss = flamingo_loss_fn(port, train=True, freeze_video_bn_stats=True, **MIXING)
    kw = dict(grad_accum_steps=2, param_labels=labels)
    if mode != "in_scan":
        kw["precompute_fn"] = flamingo_tower_precompute(port, train=True,
                                                        freeze_video_bn_stats=True, **MIXING)
    return TrainState.create(port, opt), make_train_step(loss, **kw), labels


@pytest.mark.parametrize("mode", ["fused", "in_scan"])
def test_torch_hoisted_step_matches_jax(jax_run, mode):
    want, jstate, base, batches = jax_run
    port = copy.deepcopy(base)
    state, run, labels = _port_step(port, mode)
    _, frozen0 = trained_and_frozen(port, labels)
    stats0 = port_batch_stats(port)
    tower_calls = []
    port.video_model.register_forward_hook(lambda *args: tower_calls.append(1))
    for i, batch in enumerate(batches):
        state, m = run(state, batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), want[i][key], rtol=2e-5,
                                       err_msg=f"{mode} {key} step {i + 1}")
    assert len(tower_calls) == (6 if mode == "in_scan" else 3)
    assert_params_close(port, labels, jstate.params, frozen0)
    assert all(torch.equal(v, stats0[k]) for k, v in port_batch_stats(port).items())

