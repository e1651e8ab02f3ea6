"""The Flamingo train step, towers in the scan, against the JAX package
(CPU, fp32).

Three accumulated steps (2 micro-batches of 2, lip video with padded
frames) of the port's ``make_train_step`` with ``param_labels`` from
``select_optimizer`` (the Flamingo regime: gated ``x_attn``/``x_mlp``,
their gates and ``video_projection`` train, everything else frozen)
against ``avsl_tpu.train.make_train_step`` with the same labels, on the
tiny Whisper-Flamingo model carried from JAX, every tower rate 0 and
BatchNorm on batch statistics, so each micro-step updates the running
statistics the next one reads. The canonical AV-mode mixing (prob_av 1,
prob_a 0.5) draws every micro-step and always picks AV. Loss and
grad_norm per step rtol 2e-5 (as ``tests/test_torch_train.py``); trained
parameters after 3 steps atol 1e-5; frozen parameters bit-identical to
where they started; running statistics atol 1e-5 (fp32 sums in other
orders over 3 x 2 updates).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.core.config import FlamingoTrainConfig as JaxTrainConfig
from avsl_tpu.train import TrainState as JaxTrainState
from avsl_tpu.train import make_train_step as jax_make_train_step
from avsl_tpu.train.objectives import flamingo_loss_fn as jax_loss_fn
from avsl_tpu.train.optim import select_optimizer as jax_select_optimizer
from avsl_tpu_torch.core.config import FlamingoTrainConfig
from avsl_tpu_torch.models import state_dict_from_flax
from avsl_tpu_torch.train import TrainState, flamingo_loss_fn, make_train_step, select_optimizer
from avsl_tpu_torch.train.optim import TRAIN
from test_torch_flamingo_common import (  # noqa: F401 (fixture)
    assert_batch_stats_close,
    carried_flamingo,
    one_torch_thread,
)
from test_torch_flamingo_loss import make_batch

TRAIN_CFG = dict(learning_rate=1e-3, warmup_steps=1, num_train_steps=20, weight_decay=0.01,
                 add_gated_x_attn=1, prob_use_av=1.0, prob_use_a=0.5)
MIXING = dict(prob_av=1.0, prob_a=0.5)


def flamingo_setup():
    """(jax model, jax state, jax labels, port model, port optimizer, port
    labels, cfg, batches) for 3 steps of [2, 2]."""
    jmodel, variables, port, cfg = carried_flamingo()
    tx, jlabels = jax_select_optimizer(variables["params"], JaxTrainConfig(**TRAIN_CFG), 20)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, variables["params"]), tx,
                                  batch_stats=variables["batch_stats"])
    opt, labels = select_optimizer(port, FlamingoTrainConfig(**TRAIN_CFG), 20)
    rng = np.random.default_rng(6)
    batches = [make_batch(cfg, rng, lead=(2, 2)) for _ in range(3)]
    return jmodel, jstate, jlabels, tx, port, opt, labels, cfg, batches


def trained_and_frozen(port, labels):
    """Copies of the port's trained and frozen parameters by name."""
    named = dict(port.named_parameters())
    return ({n: p.detach().clone() for n, p in named.items() if labels[n] == TRAIN},
            {n: p.detach().clone() for n, p in named.items() if labels[n] != TRAIN})


def assert_params_close(port, labels, jax_params, frozen_before, atol=1e-5):
    """Trained tensors against JAX's; frozen ones bit-identical to before."""
    want = state_dict_from_flax(jax.device_get(jax_params))
    n_trained = 0
    for name, p in port.named_parameters():
        if labels[name] == TRAIN:
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=atol, rtol=0,
                                       err_msg=name)
            n_trained += 1
        else:
            assert torch.equal(p.detach(), frozen_before[name]), name
    assert n_trained > 20


@pytest.fixture(scope="module")
def setup():
    return flamingo_setup()


def test_torch_flamingo_train_step_matches_jax(setup):
    jmodel, jstate, jlabels, tx, port, opt, labels, cfg, batches = setup
    jstep = jax_make_train_step(jax_loss_fn(jmodel, train=True, **MIXING), tx, grad_accum_steps=2,
                                donate=False, param_labels=jlabels)
    pstate = TrainState.create(port, opt)
    pstep = make_train_step(flamingo_loss_fn(port, train=True, **MIXING), grad_accum_steps=2,
                            param_labels=labels)
    trained0, frozen0 = trained_and_frozen(port, labels)
    assert {n for n in trained0} == {n for n in opt.names}
    assert all(("x_attn" in n or "x_mlp" in n or "video_projection" in n) for n in trained0)
    lrs = []
    for i, batch in enumerate(batches):
        lrs.append(opt.learning_rate())
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, pm = pstep(pstate, batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=2e-5,
                                       err_msg=f"{key} step {i + 1}")
        if i == 0:  # learning rate 0: nothing moves but the statistics
            assert all(torch.equal(p, trained0[n]) for n, p in port.named_parameters()
                       if n in trained0)
    assert lrs[0] == 0.0 and pstate.step == 3 and opt.count == 3
    assert_params_close(port, labels, jstate.params, frozen0)
    assert any(not torch.equal(p.detach(), trained0[n]) for n, p in port.named_parameters()
               if n in trained0)
    assert_batch_stats_close(port, jstate.batch_stats, atol=1e-5)
