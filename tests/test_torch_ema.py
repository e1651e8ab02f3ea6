"""Parameter EMA and checkpoint averaging of the port (``train/ema.py``,
``cli/avg_ckpt.py``, the runner's EMA) against the JAX package (CPU).

The cases of ``tests/test_ema.py``: ``ema_update`` against JAX's at rtol
1e-6 in fp32 and within a bf16 ulp in bf16 (int entries from ``new``),
convergence to a
constant, ``tree_average``'s math and dtype, ``average_checkpoint_steps``
(all, chosen and the last k steps; provenance from the newest; a missing
step raises), ``cli.avg_ckpt --smoke --device cpu`` on the tiny Flamingo
state with the soup served by ``cli.transcribe --ckpt_dir``, and the
runner: validation and ``best/`` see the EMA while the
rolling checkpoint keeps the raw state, side by side with JAX's runner
(raw and EMA at rtol 1e-6); under ``MultiSteps`` the EMA follows every
micro-batch (a hand count); a resume restarts it from the restored
tensors. Last, the scope chosen for the EMA (the trained tensors; the
frozen ones are the live ones): JAX's EMA of a frozen tensor stays
within one fp32 ulp (2^-23 relative) an update of it, over 100 updates.
"""

import numpy as np
import optax
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from avsl_tpu.train.ema import ema_update as jax_ema_update
from avsl_tpu.train.ema import tree_average as jax_tree_average
from avsl_tpu_torch.train.checkpoints import restore_params_only, save_checkpoint
from avsl_tpu_torch.train.ema import average_checkpoint_steps, ema_update, tree_average
from avsl_tpu_torch.train.loop import TrainState
from avsl_tpu_torch.train.optim import MultiSteps, constant_adamw
from avsl_tpu_torch.train.runner import TrainerRunner
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_ema_update_matches_jax(dtype):
    rng = np.random.default_rng(0)
    e = rng.normal(size=(5, 7)).astype(np.float32)
    news = [rng.normal(size=(5, 7)).astype(np.float32) for _ in range(20)]
    tdt = getattr(torch, dtype)
    ema = {"w": torch.tensor(e).to(tdt), "step": torch.tensor(0)}
    jema = {"w": jnp.asarray(e, dtype), "step": jnp.asarray(0, jnp.int32)}
    for i, n in enumerate(news):
        ema = ema_update(ema, {"w": torch.tensor(n).to(tdt), "step": torch.tensor(i)}, 0.9)
        jema = jax_ema_update(jema, {"w": jnp.asarray(n, dtype), "step": jnp.asarray(i)}, 0.9)
    assert ema["w"].dtype == tdt and int(ema["step"]) == 19  # ints pass through from new
    # bf16: XLA rounds the fused expression once, the foreach ops after each
    # op, so within a bf16 ulp (2^-7 at |w| < 2)
    tol = dict(rtol=1e-6) if dtype == "float32" else dict(rtol=0, atol=2.0 ** -7)
    np.testing.assert_allclose(ema["w"].float().numpy(), np.asarray(jema["w"], np.float32), **tol)
    once = ema_update({"w": torch.ones(3)}, {"w": torch.full((3,), 3.0)}, 0.9)
    np.testing.assert_allclose(once["w"].numpy(), 1.0 * 0.9 + 3.0 * 0.1, rtol=1e-7)


def test_torch_ema_converges_to_constant_target():
    ema = {"w": torch.zeros(())}
    for _ in range(300):
        ema = ema_update(ema, {"w": torch.tensor(5.0)}, 0.95)
    assert abs(float(ema["w"]) - 5.0) < 1e-4


def test_torch_tree_average_math_and_dtype():
    trees = [{"a": torch.tensor([1.0, 2.0], dtype=torch.bfloat16), "n": torch.tensor(3)},
             {"a": torch.tensor([3.0, 6.0], dtype=torch.bfloat16), "n": torch.tensor(9)}]
    avg = tree_average(trees)
    want = jax_tree_average([{k: jnp.asarray(v.float().numpy(), jnp.bfloat16 if k == "a" else None)
                              for k, v in t.items()} for t in trees])
    np.testing.assert_allclose(avg["a"].float().numpy(), np.asarray(want["a"], np.float32))
    np.testing.assert_allclose(avg["a"].float().numpy(), [2.0, 4.0])
    assert avg["a"].dtype == torch.bfloat16 and int(avg["n"]) == 3
    with pytest.raises(ValueError):
        tree_average([])


def _linear_state(val: float, step: int) -> TrainState:
    model = nn.Linear(4, 2)
    with torch.no_grad():
        model.weight.fill_(val)
        model.bias.fill_(val)
    state = TrainState.create(model, constant_adamw(dict(model.named_parameters()), 1e-3))
    state.step = step
    return state


def test_torch_average_checkpoint_steps_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    for val, step in [(1.0, 10), (2.0, 20), (6.0, 30)]:
        save_checkpoint(d, _linear_state(val, step), step)
    soup, used = average_checkpoint_steps(d, _linear_state(0.0, 0))
    np.testing.assert_allclose(soup.model.weight.detach().numpy(), 3.0)
    assert soup.step == 30 and used == [10, 20, 30]
    soup2, _ = average_checkpoint_steps(d, _linear_state(0.0, 0), steps=[10, 30])
    np.testing.assert_allclose(soup2.model.bias.detach().numpy(), 3.5)
    soup3, used3 = average_checkpoint_steps(d, _linear_state(0.0, 0), last_k=2)
    np.testing.assert_allclose(soup3.model.weight.detach().numpy(), 4.0)
    assert used3 == [20, 30]
    with pytest.raises(ValueError, match="not in"):
        average_checkpoint_steps(d, _linear_state(0.0, 0), steps=[10, 99])


def test_torch_avg_ckpt_cli_smoke(tmp_path):
    """Two checkpoints of the CLI's own template (the second shifted by
    0.5 on every float tensor, BatchNorm statistics included): the soup
    restores to the mean at the newest step."""
    from avsl_tpu_torch.cli.avg_ckpt import build_state, main
    from avsl_tpu_torch.core.config import FlamingoTrainConfig

    cfg = FlamingoTrainConfig(model_name="test", audio_max_length=16000)
    base = build_state(cfg, smoke=True, device="cpu")
    sd0 = {k: v.clone() for k, v in base.model.state_dict().items()}
    d = str(tmp_path / "ckpt")
    for delta, step in [(0.0, 1), (0.5, 2)]:
        base.model.load_state_dict({k: v + delta for k, v in sd0.items()})
        base.step = step
        save_checkpoint(d, base, step)
    out = str(tmp_path / "soup")
    soup = main(["--ckpt_dir", d, "--output", out, "--smoke", "--device", "cpu"])
    assert soup.step == 2
    restored = restore_params_only(out, 2)
    assert sorted(restored) == sorted(sd0) and any("running_mean" in k for k in sd0)
    for key, value in restored.items():
        np.testing.assert_allclose(value.numpy(), (sd0[key] + 0.25).numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    # and cli.transcribe --ckpt_dir serves the soup
    import scipy.io.wavfile as wavfile

    from avsl_tpu_torch.cli import transcribe

    seg = tmp_path / "segs"
    seg.mkdir()
    x = 0.2 * np.sin(2 * np.pi * 220 * np.arange(16000) / 16000)
    wavfile.write(str(seg / "seg0.wav"), 16000, (x * 32767).astype(np.int16))
    served = transcribe.main(["--input", str(seg), "--smoke", "--device", "cpu", "--ckpt_dir", out,
                              "--max_new_tokens", "4"])
    # (every tensor shifted by 0.25 is no model: only the load and the decode are checked)
    assert [r["id"] for r in served] == ["seg0"] and isinstance(served[0]["text"], str)


class _Tok:
    eot = 9
    special_token_set = {9}

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


class _Cfg:
    gradient_accumulation_steps = 1
    early_stop_patience = 0
    resume_training = False
    ema_decay = 0.98


class _W(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(()))


def _runner(tmp_path, opt_fn=lambda params: constant_adamw(params, 0.2, weight_decay=0.0),
            cfg=None):
    """JAX's test problem in the port: adam at lr 0.2 pulls w from 0 to 1;
    validation is perfect only while the evaluated w stays below 0.5."""
    model = _W()
    opt = opt_fn(dict(model.named_parameters()))

    def loss_fn(batch, generator):
        return ((model.w - torch.as_tensor(batch["x"])) ** 2).mean(), {}

    def eval_logits(state, batch):
        labels = torch.as_tensor(batch["labels"])
        good = torch.nn.functional.one_hot(labels, 10).float() * 10.0
        bad = torch.nn.functional.one_hot((labels + 3) % 8, 10).float() * 10.0
        return torch.where(state.model.w < 0.5, good, bad)

    return TrainerRunner(loss_fn, eval_logits, None, TrainState.create(model, opt), _Tok(),
                         cfg or _Cfg(), log_dir=str(tmp_path / "logs"),
                         ckpt_dir=str(tmp_path / "ckpt"))


def _train_batches(epoch=0):
    return iter([{"x": np.ones((4,), np.float32)} for _ in range(100)])


def _val_batches():
    return iter([{"labels": np.asarray([[1, 2, 3, 9]]), "x": np.ones((1,), np.float32)}])


def test_torch_runner_validates_and_pins_best_with_ema(tmp_path):
    from avsl_tpu.train.loop import TrainState as JaxTrainState
    from avsl_tpu.train.runner import TrainerRunner as JaxTrainerRunner

    runner = _runner(tmp_path / "port")
    result = runner.fit(_train_batches, _val_batches, num_steps=8, validate_every=8)
    raw_w, ema_w = float(runner.state.model.w.detach()), float(runner.ema["w"])
    assert raw_w > 0.5 and ema_w < 0.5, (raw_w, ema_w)
    assert result["best_wer"] == 0.0  # validation saw the EMA weights
    best = restore_params_only(str(tmp_path / "port" / "ckpt" / "best"), 8)
    rolling = restore_params_only(str(tmp_path / "port" / "ckpt"), 8)
    np.testing.assert_allclose(float(best["w"]), ema_w, rtol=1e-6)
    np.testing.assert_allclose(float(rolling["w"]), raw_w, rtol=1e-6)
    assert float(runner.state.model.w) == raw_w  # the live tensor is back

    # JAX's runner on the same problem
    tx = optax.adam(0.2)

    def jloss(params, batch_stats, batch, rng):
        return jnp.mean((params["w"] - batch["x"]) ** 2), ({}, batch_stats)

    def jeval(state, batch):
        labels = batch["labels"]
        good = jax.nn.one_hot(labels, 10) * 10.0
        return jnp.where(state.params["w"] < 0.5, good,
                         jax.nn.one_hot((labels + 3) % 8, 10) * 10.0)

    jrunner = JaxTrainerRunner(jloss, jeval, tx, JaxTrainState.create({"w": jnp.zeros(())}, tx),
                               _Tok(), _Cfg(), log_dir=str(tmp_path / "jax_logs"),
                               ckpt_dir=str(tmp_path / "jax_ckpt"))
    jresult = jrunner.fit(train_batches=_train_batches, val_batches=_val_batches, num_steps=8,
                          validate_every=8)
    assert jresult["best_wer"] == result["best_wer"]
    np.testing.assert_allclose(raw_w, float(jrunner.state.params["w"]), rtol=1e-6)
    np.testing.assert_allclose(ema_w, float(jrunner._ema_params["w"]), rtol=1e-6)


def test_torch_runner_ema_follows_every_micro_batch(tmp_path):
    """MultiSteps over 3: the parameters move every third call, and the EMA
    is updated after each of the 7 calls, against a hand count."""
    runner = _runner(tmp_path, lambda params: MultiSteps(
        constant_adamw(params, 0.2, weight_decay=0.0), 3))
    seen = []
    plain = runner.train_step

    def step(state, batch):
        state, metrics = plain(state, batch)
        seen.append(float(state.model.w))
        return state, metrics

    runner.train_step = step
    runner.fit(_train_batches, None, num_steps=7)
    assert len(seen) == 7 and len(set(seen)) == 3  # 0, and after updates 3 and 6
    e = torch.zeros(())
    for w in seen:
        e = e * 0.98 + torch.tensor(w) * (1 - 0.98)
    assert float(runner.ema["w"]) == float(e)


def test_torch_runner_resume_resets_ema(tmp_path):
    runner = _runner(tmp_path)
    runner.fit(_train_batches, None, num_steps=5)
    assert float(runner.ema["w"]) != float(runner.state.model.w)
    cfg = _Cfg()
    cfg.resume_training = True
    resumed = _runner(tmp_path, cfg=cfg)
    assert resumed.maybe_resume() == 5
    assert float(resumed.ema["w"]) == float(resumed.state.model.w) == float(runner.state.model.w)


def test_torch_ema_scope_frozen_tensors_drift_within_tolerance():
    """The port keeps the EMA of the trained tensors and uses the frozen
    ones as they are; JAX's EMA covers the whole tree, where a frozen
    tensor's average moves by rounding only: within one fp32 ulp (2^-23
    relative) an update, over 100 updates at decay 0.999."""
    x = jnp.asarray(np.random.default_rng(1).normal(size=(4096,)).astype(np.float32))
    e = {"f": x}
    for _ in range(100):
        e = jax_ema_update(e, {"f": x}, 0.999)
    rel = np.abs(np.asarray(e["f"]) - np.asarray(x)) / np.abs(np.asarray(x))
    assert 0 < rel.max() <= 100 * 2.0 ** -23, rel.max()
