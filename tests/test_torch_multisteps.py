"""Cross-batch gradient accumulation (``MultiSteps``) against
``optax.MultiSteps`` (CPU, fp32).

* The wrapper alone, on seeded gradients of varying scale with ``every_k``
  3 and a clip that binds: parameters, moments and learning rate after
  every call against ``optax.MultiSteps(chain(clip_by_global_norm,
  adamw))`` (atol 1e-6): one weight per micro-batch, the clip on the norm
  of the mean, the schedule advancing once per update.
* The tiny Whisper-Flamingo model carried from JAX (every tower rate 0,
  BatchNorm on batch statistics) trained on bucketed batches of 3, 1, 2, 4,
  2 and 3 items with accumulation 2, through ``cli.finetune.make_runner``
  with ``cross_batch`` (the CLI's non-smoke composition: ``MultiSteps``
  and a runner accumulation of 1), against ``avsl_tpu.train.make_train_step``
  with ``optax.MultiSteps(select_optimizer(...))``: the micro-batch's loss
  and grad_norm (rtol 2e-5, as ``tests/test_torch_flamingo_train.py``),
  the trained parameters after every micro-step (atol 1e-5, as there),
  unchanged after the odd ones, the learning rate of each update, and the
  frozen ones bit-identical. The clip is set to 0.05 so that it binds.
* A checkpoint written after micro-step 3, mid-accumulation, resumes to
  the same parameters, bit for bit, as the run that went on.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.core.config import FlamingoTrainConfig as JaxTrainConfig
from avsl_tpu.train import TrainState as JaxTrainState
from avsl_tpu.train import make_train_step as jax_make_train_step
from avsl_tpu.train.objectives import flamingo_loss_fn as jax_loss_fn
from avsl_tpu.train.optim import linear_warmup_decay as jax_schedule
from avsl_tpu.train.optim import select_optimizer as jax_select_optimizer
from avsl_tpu_torch.cli import finetune
from avsl_tpu_torch.core.config import FlamingoTrainConfig
from avsl_tpu_torch.data.tokenizer import get_tokenizer
from avsl_tpu_torch.models import state_dict_from_flax
from avsl_tpu_torch.train.checkpoints import restore_checkpoint, save_checkpoint
from avsl_tpu_torch.train.optim import TRAIN, ClippedAdamW, MultiSteps, linear_warmup_decay
from test_torch_flamingo_common import carried_flamingo, one_torch_thread  # noqa: F401
from test_torch_flamingo_loss import make_batch

SIZES = (3, 1, 2, 4, 2, 3)
CLIP = 0.05  # read by both packages' optimizers as getattr(cfg, "clip_norm")
TRAIN_CFG = dict(learning_rate=1e-3, warmup_steps=1, num_train_steps=20, weight_decay=0.01,
                 add_gated_x_attn=1, prob_use_av=1.0, prob_use_a=0.5,
                 gradient_accumulation_steps=2, spec_augment=None,
                 freeze_video_batch_norm_stats=False)


def test_torch_multisteps_matches_optax():
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    tx = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(0.3),
                                      optax.adamw(jax_schedule(0.1, 2, 10), **kw)),
                          every_k_schedule=3)
    jparams = [jnp.asarray(p) for p in params]
    jstate = tx.init(jparams)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    opt = MultiSteps(ClippedAdamW({str(i): p for i, p in enumerate(tparams)},
                                  linear_warmup_decay(0.1, 2, 10), clip_norm=0.3, **kw), 3)
    for call in range(10):
        # the scale varies by 30x from call to call, as batch sizes and
        # lengths make it vary
        g = [(rng.standard_normal(s) * (0.05 + 1.5 * (call % 3))).astype(np.float32)
             for s in shapes]
        lr = opt.learning_rate()
        updates, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        grads = [torch.from_numpy(x.copy()) for x in g]
        updated = opt.step(grads)
        assert updated == (call % 3 == 2) and opt.mini_step == (call + 1) % 3
        assert all(np.array_equal(t.numpy(), x) for t, x in zip(grads, g))  # left untouched
        for t, j in zip(tparams, jparams):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=0)
        if updated:
            inner = jstate.inner_opt_state[1][0]
            assert opt.count == int(inner.count) == call // 3 + 1
            assert np.float32(lr) == np.float32(jax_schedule(0.1, 2, 10)(call // 3))
            for t, j in zip(opt.inner.mu, inner.mu):
                np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=0)
    for t, j in zip(opt.acc, jstate.acc_grads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=0)


def _config(cls):
    cfg = cls(**TRAIN_CFG)
    cfg.clip_norm = CLIP
    return cfg


def _port_runner(port, tmp_path, name):
    cfg = _config(FlamingoTrainConfig)
    tok = get_tokenizer(None, "en")
    return finetune.make_runner(cfg, port, tok, log_dir=str(tmp_path / name / "logs"),
                                ckpt_dir=str(tmp_path / name / "ckpt"), cross_batch=True)


@pytest.fixture(scope="module")
def carried():
    jmodel, variables, port, cfg = carried_flamingo()
    rng = np.random.default_rng(6)
    batches = [make_batch(cfg, rng, lead=(b,)) for b in SIZES]
    start = {k: v.clone() for k, v in port.state_dict().items()}
    return jmodel, variables, port, cfg, batches, start


def test_torch_multisteps_flamingo_matches_jax(carried, tmp_path):
    jmodel, variables, port, cfg, batches, start = carried
    port.load_state_dict(start)
    runner = _port_runner(port, tmp_path, "run")
    opt = runner.state.optimizer
    assert isinstance(opt, MultiSteps) and runner.accum == 1 and not runner.hoisted
    labels = {n: (TRAIN if n in opt.names else "frozen") for n, _ in port.named_parameters()}
    inner_tx, jlabels = jax_select_optimizer(variables["params"], _config(JaxTrainConfig), 20)
    tx = optax.MultiSteps(inner_tx, every_k_schedule=2)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, variables["params"]), tx,
                                  batch_stats=variables["batch_stats"])
    jstep = jax_make_train_step(jax_loss_fn(jmodel, train=True, prob_av=1.0, prob_a=0.5), tx,
                                donate=False, param_labels=jlabels)
    named = dict(port.named_parameters())
    frozen0 = {n: p.detach().clone() for n, p in named.items() if labels[n] != TRAIN}
    lrs = []
    for i, batch in enumerate(batches):
        before = {n: named[n].detach().clone() for n in opt.names}
        if i % 2 == 1:
            lrs.append(opt.learning_rate())
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        runner.state, pm = runner.train_step(runner.state, batch)
        for key in ("loss", "grad_norm"):  # the micro-batch's own
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=2e-5,
                                       err_msg=f"{key} micro-step {i + 1}")
        assert float(pm["grad_norm"]) > 4 * CLIP  # the clip binds
        want = state_dict_from_flax(jax.device_get(jstate.params))
        for n in opt.names:
            np.testing.assert_allclose(named[n].detach().numpy(), want[n].numpy(), atol=1e-5,
                                       rtol=0, err_msg=f"{n} micro-step {i + 1}")
        moved = any(not torch.equal(named[n], before[n]) for n in opt.names)
        assert moved == (i in (3, 5)), i + 1  # update 1 has learning rate 0
    assert opt.count == 3 and opt.mini_step == 0 and runner.state.step == len(SIZES)
    assert int(jstate.opt_state.gradient_step) == 3
    assert lrs == [linear_warmup_decay(1e-3, 1, 20)(k) for k in range(3)]
    assert [np.float32(x) for x in lrs] == [np.float32(jax_schedule(1e-3, 1, 20)(k))
                                             for k in range(3)]
    assert all(torch.equal(p, frozen0[n]) for n, p in named.items() if n in frozen0)


def test_torch_multisteps_checkpoint_resumes_mid_accumulation(carried, tmp_path):
    _, _, port, _, batches, start = carried
    port.load_state_dict(start)
    runner = _port_runner(port, tmp_path, "a")
    for i, batch in enumerate(batches):
        runner.state, _ = runner.train_step(runner.state, batch)
        if i == 2:
            assert runner.state.optimizer.mini_step == 1
            save_checkpoint(str(tmp_path / "mid"), runner.state, runner.state.step)
    went_on = {n: p.detach().clone() for n, p in port.named_parameters()}

    port.load_state_dict(start)
    resumed = _port_runner(port, tmp_path, "b")
    resumed.state = restore_checkpoint(str(tmp_path / "mid"), resumed.state)
    opt = resumed.state.optimizer
    assert resumed.state.step == 3 and opt.mini_step == 1 and opt.count == 1
    assert any(bool(a.any()) for a in opt.acc)  # the half-full accumulator came back
    for batch in batches[3:]:
        resumed.state, _ = resumed.train_step(resumed.state, batch)
    for n, p in port.named_parameters():
        assert torch.equal(p.detach(), went_on[n]), n
