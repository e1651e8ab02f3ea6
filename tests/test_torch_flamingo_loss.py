"""The Flamingo loss with video, and the frozen-tower precompute, against
the JAX package (CPU, fp32).

On the tiny Whisper-Flamingo model carried from JAX (every tower rate 0,
Whisper dropout 0, no SpecAugment), ``flamingo_loss_fn`` with lip video in
training at (prob_av, prob_a) = (1, 0), (0, 1) and (0, 0): AV, audio-only
(the projected video scaled by 0) and video-only (the mel zeroed), each
deterministic whatever the draw. The loss rtol 2e-5 (as
``tests/test_torch_train.py`` holds it), the BatchNorm statistics the
micro-step leaves atol 1e-5, and the gradients of the tensors the
Flamingo regime trains atol 2e-6 + rtol 1e-4 (fp32, other summation
orders). Then eval mode (running statistics, untouched), and
``flamingo_tower_precompute`` over a stacked [2, 2] batch: its context
atol 1e-4, and the hoisted loss of each micro-step rtol 2e-5.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.train.objectives import flamingo_loss_fn as jax_loss_fn
from avsl_tpu.train.objectives import flamingo_tower_precompute as jax_precompute
from avsl_tpu_torch.models import state_dict_from_flax
from avsl_tpu_torch.train.objectives import flamingo_loss_fn, flamingo_tower_precompute
from test_torch_flamingo_common import (
    assert_batch_stats_close,
    carried_flamingo,
    one_torch_thread,  # noqa: F401 (fixture)
    port_batch_stats,
)

TRAINED = ("x_attn", "x_mlp", "video_projection")


@pytest.fixture(scope="module")
def carried():
    return carried_flamingo()


def make_batch(cfg, rng, lead=(2,), frames=6):
    """A collated Flamingo batch with leading axes ``lead``: mel, tokens,
    labels (-100 past 4), lip clips of ``frames`` frames with a mask of
    1..frames real frames per item."""
    labels = rng.integers(0, cfg.n_vocab, size=lead + (6,))
    labels[..., 4:] = -100
    lengths = rng.integers(1, frames + 1, size=lead)
    return {
        "input_ids": rng.normal(size=lead + (cfg.n_mels, 100)).astype(np.float32),
        "dec_input_ids": rng.integers(0, cfg.n_vocab, size=lead + (6,)),
        "labels": labels,
        "video": rng.normal(size=lead + (frames, 48, 48, 1)).astype(np.float32),
        "video_mask": np.arange(frames) < lengths[..., None],
    }


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def assert_trained_grads_close(port, jax_grads):
    """The port's gradients of the trained tensors against JAX's."""
    want = state_dict_from_flax(jax.device_get(jax_grads))
    checked = 0
    for name, p in port.named_parameters():
        if any(t in name for t in TRAINED):
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=2e-6, rtol=1e-4,
                                       err_msg=name)
            checked += 1
    assert checked > 20


@pytest.mark.parametrize("prob_av,prob_a", [(1.0, 0.0), (0.0, 1.0), (0.0, 0.0)],
                         ids=["av", "audio_only", "video_only"])
def test_torch_flamingo_loss_with_video_matches_jax(carried, prob_av, prob_a):
    jmodel, variables, base, cfg = carried
    batch = make_batch(cfg, np.random.default_rng(1))
    jloss = jax_loss_fn(jmodel, train=True, prob_av=prob_av, prob_a=prob_a)

    def f(params):
        loss, (_, stats) = jloss(params, variables["batch_stats"], _jnp(batch),
                                 jax.random.PRNGKey(0))
        return loss, stats

    (want, new_stats), want_g = jax.jit(jax.value_and_grad(f, has_aux=True))(variables["params"])
    port = copy.deepcopy(base)
    before = port_batch_stats(port)
    loss, metrics = flamingo_loss_fn(port, train=True, prob_av=prob_av, prob_a=prob_a)(
        _torch(batch), torch.Generator().manual_seed(0))
    loss.backward()
    assert metrics == {} and port.training
    np.testing.assert_allclose(float(loss), float(want), rtol=2e-5)
    assert_batch_stats_close(port, new_stats, atol=1e-5)
    assert any(not torch.equal(v, before[k]) for k, v in port_batch_stats(port).items())
    assert_trained_grads_close(port, want_g)


def test_torch_flamingo_loss_modes_differ(carried):
    """The three modes give three losses (the draws reach the model)."""
    _, _, base, cfg = carried
    batch = _torch(make_batch(cfg, np.random.default_rng(1)))
    losses = set()
    for prob_av, prob_a in ((1.0, 0.0), (0.0, 1.0), (0.0, 0.0)):
        port = copy.deepcopy(base)
        with torch.no_grad():
            loss, _ = flamingo_loss_fn(port, train=True, prob_av=prob_av, prob_a=prob_a)(
                batch, torch.Generator().manual_seed(0))
        losses.add(round(float(loss), 5))
    assert len(losses) == 3


def test_torch_flamingo_eval_loss_matches_jax(carried):
    """Eval mode: BatchNorm on the running statistics, which stay."""
    jmodel, variables, base, cfg = carried
    batch = make_batch(cfg, np.random.default_rng(2))
    want, (_, stats) = jax.jit(jax_loss_fn(jmodel, train=False, prob_av=0.0, prob_a=1.0))(
        variables["params"], variables["batch_stats"], _jnp(batch), jax.random.PRNGKey(0))
    port = copy.deepcopy(base)
    before = port_batch_stats(port)
    with torch.no_grad():
        loss, _ = flamingo_loss_fn(port, train=False, prob_av=0.0, prob_a=1.0)(_torch(batch), None)
    assert not port.training
    np.testing.assert_allclose(float(loss), float(want), rtol=2e-5)
    assert all(torch.equal(v, before[k]) for k, v in port_batch_stats(port).items())
    assert_batch_stats_close(port, stats, atol=0.0)


@pytest.mark.parametrize("prob_av,prob_a", [(1.0, 0.5), (0.0, 1.0)], ids=["canonical", "audio_only"])
def test_torch_tower_precompute_matches_jax(carried, prob_av, prob_a):
    """The batched frozen-tower forward over [accum=2, micro=2] with
    running-statistics BatchNorm, then each micro-step's hoisted loss."""
    jmodel, variables, base, cfg = carried
    batch = make_batch(cfg, np.random.default_rng(3), lead=(2, 2))
    want = jax.jit(jax_precompute(jmodel, train=True, freeze_video_bn_stats=True, prob_av=prob_av,
                                  prob_a=prob_a))(variables["params"], variables["batch_stats"],
                                                  _jnp(batch), jax.random.PRNGKey(0))
    port = copy.deepcopy(base)
    before = port_batch_stats(port)
    ctx = flamingo_tower_precompute(port, train=True, freeze_video_bn_stats=True,
                                    prob_av=prob_av, prob_a=prob_a)(
        _torch(batch), torch.Generator().manual_seed(0))
    assert sorted(ctx) == sorted(want) == ["enc_features", "video_feats", "video_scale"]
    assert ctx["enc_features"].shape == (2, 2, 50, cfg.n_audio_state)
    assert ctx["video_feats"].shape == (2, 2, 6, cfg.video_state)
    assert not any(v.requires_grad for v in ctx.values())
    for key in sorted(ctx):
        np.testing.assert_allclose(ctx[key].numpy(), np.asarray(want[key]), atol=1e-4, err_msg=key)
    assert all(torch.equal(v, before[k]) for k, v in port_batch_stats(port).items())
    jloss = jax.jit(jax_loss_fn(jmodel, train=True, freeze_video_bn_stats=True, prob_av=prob_av,
                                prob_a=prob_a))
    ploss = flamingo_loss_fn(port, train=True, freeze_video_bn_stats=True, prob_av=prob_av,
                             prob_a=prob_a)
    for i in range(2):
        micro = {k: v[i] for k, v in batch.items()}
        jl, _ = jloss(variables["params"], variables["batch_stats"],
                      {**_jnp(micro), **{k: v[i] for k, v in want.items()}}, jax.random.PRNGKey(1))
        with torch.no_grad():
            pl, _ = ploss({**_torch(micro), **{k: v[i] for k, v in ctx.items()}},
                          torch.Generator().manual_seed(1))
        np.testing.assert_allclose(float(pl), float(jl), rtol=2e-5)
