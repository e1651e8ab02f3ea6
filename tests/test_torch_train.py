"""Port training layer against the JAX package (CPU).

Each piece of the audio-only fine-tuning path is held against its
``avsl_tpu`` counterpart on the same numbers, made with numpy:
``cross_entropy_loss``, the warmup/decay schedule, clip + AdamW over 3
steps against optax, SpecAugment's apply given JAX's draws, residual
dropout, the dataset and collator, bf16-compute/fp32-param logits, and the
whole train step against ``avsl_tpu.train.make_train_step`` (fp32,
dropout 0, no SpecAugment, accumulation 2, 3 steps). Tolerances are
stated where they are used, with their reasons.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
import optax

from avsl_tpu.core.config import FlamingoTrainConfig as JaxTrainConfig
from avsl_tpu.core.config import WhisperConfig as JaxWhisperConfig
from avsl_tpu.models import Whisper as JaxWhisper
from avsl_tpu.models.avhubert import cross_entropy_loss as jax_cross_entropy
from avsl_tpu.models.convert import convert_whisper_state_dict
from avsl_tpu.train import TrainState as JaxTrainState
from avsl_tpu.train import make_train_step as jax_make_train_step
from avsl_tpu.train.objectives import flamingo_loss_fn as jax_flamingo_loss_fn
from avsl_tpu.train.optim import linear_warmup_decay as jax_schedule
from avsl_tpu.train.optim import whisper_optimizer as jax_whisper_optimizer
from avsl_tpu_torch.core.config import FlamingoTrainConfig
from avsl_tpu_torch.kernels.specaugment import (
    F_MAX,
    T_MAX,
    apply_spec_augment,
    draw_spec_augment,
    spec_augment_batch,
)
from avsl_tpu_torch.models import build_whisper_flamingo, whisper_state_dict_from_flax
from avsl_tpu_torch.models.avhubert import cross_entropy_loss
from avsl_tpu_torch.models.convert import _flatten
from avsl_tpu_torch.models.layers import residual_dropout
from avsl_tpu_torch.train import TrainState, flamingo_loss_fn, make_train_step, whisper_optimizer
from avsl_tpu_torch.train.optim import FROZEN, TRAIN, label_params, linear_warmup_decay


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_torch_cross_entropy_matches_jax(smoothing):
    """fp32 log-softmax in both; atol 1e-6 (fp32, other summation order)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, size=(3, 5))
    labels[0, 3:] = -100
    labels[2, :] = -100
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), label_smoothing=smoothing)
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                             label_smoothing=smoothing)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    empty = torch.full((2, 3), -100)
    assert float(cross_entropy_loss(torch.zeros(2, 3, 4), empty)) == 0.0


@pytest.mark.parametrize("warmup,total", [(1000, 8000), (0, 10), (3, 3), (4, 10)])
def test_torch_schedule_matches_optax(warmup, total):
    """Exact: both evaluate the same fp32 formula (rtol 1e-6)."""
    want, got = jax_schedule(1e-5, warmup, total), linear_warmup_decay(1e-5, warmup, total)
    counts = sorted({0, 1, 2, max(warmup - 1, 0), warmup, warmup + 1, total - 1, total,
                     total + 5})
    for c in counts:
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6, atol=0, err_msg=str(c))
    assert got(0) == 0.0  # the first update always has lr 0


class _Toy(nn.Module):
    def __init__(self, values):
        super().__init__()
        self.lin = nn.Linear(4, 3)
        self.scale = nn.Parameter(torch.zeros(5))
        with torch.no_grad():
            self.lin.weight.copy_(torch.from_numpy(values["lin"]["weight"]))
            self.lin.bias.copy_(torch.from_numpy(values["lin"]["bias"]))
            self.scale.copy_(torch.from_numpy(values["scale"]))


def test_torch_clip_adamw_matches_optax():
    """clip_by_global_norm + adamw over 3 steps on a small tree: step 1
    clips (norm 40 > 1), steps 2-3 do not. fp32 on both sides, the same
    operations in the same order: rtol 1e-5, atol 1e-7."""
    rng = np.random.default_rng(1)
    tree = {"lin": {"weight": rng.normal(size=(3, 4)), "bias": rng.normal(size=3)},
            "scale": rng.normal(size=5)}
    tree = jax.tree_util.tree_map(lambda x: x.astype(np.float32), tree)
    cfg = dict(learning_rate=0.1, warmup_steps=2, weight_decay=0.01, adam_epsilon=1e-8)
    jcfg, pcfg = JaxTrainConfig(**cfg), FlamingoTrainConfig(**cfg)
    tx, _ = jax_whisper_optimizer(tree, jcfg, 6)
    params, state = jax.tree_util.tree_map(jnp.asarray, tree), None
    state = tx.init(params)
    toy = _Toy(tree)
    opt, labels = whisper_optimizer(toy, pcfg, 6)
    assert set(labels.values()) == {TRAIN}
    assert sorted(opt.names) == ["lin.bias", "lin.weight", "scale"]
    for step, scale in enumerate((10.0, 0.01, 0.05)):
        grads = jax.tree_util.tree_map(
            lambda x: (scale * rng.normal(size=x.shape)).astype(np.float32), tree)
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, params)
        params = optax.apply_updates(params, updates)
        by_name = {"lin.weight": grads["lin"]["weight"], "lin.bias": grads["lin"]["bias"],
                   "scale": grads["scale"]}
        opt.step([torch.from_numpy(by_name[n]).clone() for n in opt.names])
        for name, want in (("lin.weight", params["lin"]["weight"]),
                           ("lin.bias", params["lin"]["bias"]), ("scale", params["scale"])):
            got = dict(toy.named_parameters())[name].detach().numpy()
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name} step {step + 1}")
    assert opt.count == 3


def test_torch_label_params_regimes():
    toy = nn.ModuleDict({"video_model": nn.Linear(2, 2), "x_attn": nn.Linear(2, 2),
                         "video_projection": nn.Linear(2, 2), "decoder": nn.Linear(2, 2)})
    labels = label_params(toy, trainable_patterns=(r"x_attn", r"video_projection"),
                          frozen_patterns=(r"video_model",))
    assert labels == {
        "video_model.weight": FROZEN, "video_model.bias": FROZEN,
        "x_attn.weight": TRAIN, "x_attn.bias": TRAIN,
        "video_projection.weight": TRAIN, "video_projection.bias": TRAIN,
        "decoder.weight": FROZEN, "decoder.bias": FROZEN,
    }


def _jax_spec_augment_draws(key, frames, n_mels, t_len, n_freq, n_time):
    """The (width, start) draws that avsl_tpu's spec_augment_batch makes
    from ``key``: the same key splits and randint calls, vmapped over the
    batch as it is (random bits under vmap may differ from a loop's)."""

    def one(k, af):
        keys = jax.random.split(k, 2 * (n_freq + n_time))
        af = jnp.minimum(af, t_len)
        out = []
        for m in range(n_freq + n_time):
            k_w, k_s = keys[2 * m], keys[2 * m + 1]
            if m < n_freq:
                w = jax.random.randint(k_w, (), 0, F_MAX + 1)
                s = jax.random.randint(k_s, (), 0, jnp.maximum(n_mels - w, 1))
            else:
                w = jnp.minimum(jax.random.randint(k_w, (), 0, T_MAX + 1), af)
                s = jax.random.randint(k_s, (), 0, jnp.maximum(af - w, 1))
            out.append(jnp.stack([w, s]))
        return jnp.stack(out)

    keys = jax.random.split(key, frames.shape[0])
    return np.asarray(jax.vmap(jax.jit(one))(keys, jnp.asarray(frames))).astype(np.int64)


@pytest.mark.parametrize("n_mask", [1, 2])
def test_torch_spec_augment_apply_matches_jax(n_mask):
    """Given JAX's draws, the apply reproduces avsl_tpu's output; atol 1e-6
    (the fill value is the fp32 mean, summed in another order)."""
    from avsl_tpu.kernels.specaugment import spec_augment_batch as jax_spec_augment_batch

    rng = np.random.default_rng(2)
    b, t_len, n_mels = 3, 300, 80
    mel = rng.normal(size=(b, t_len, n_mels)).astype(np.float32)
    frames = np.asarray([300, 120, 7], np.int32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax_spec_augment_batch(jnp.asarray(mel), key, jnp.asarray(frames),
                                             n_freq_mask=n_mask, n_time_mask=n_mask))
    draws = _jax_spec_augment_draws(key, frames, n_mels, t_len, n_mask, n_mask)
    got = apply_spec_augment(torch.from_numpy(mel), torch.from_numpy(draws), n_mask).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert (got != mel).any()


def test_torch_spec_augment_draws_stay_in_range():
    gen = torch.Generator().manual_seed(0)
    frames = torch.tensor([1000, 50, 0, 3000])
    draws = draw_spec_augment(frames, 80, 1000, gen, n_freq_mask=2, n_time_mask=2)
    assert draws.shape == (4, 4, 2)
    for _ in range(50):
        draws = draw_spec_augment(frames, 80, 1000, gen, n_freq_mask=2, n_time_mask=2)
        w, s = draws[..., 0], draws[..., 1]
        assert (w >= 0).all() and (s >= 0).all()
        assert (w[:, :2] <= F_MAX).all() and (s[:, :2] < torch.clamp(80 - w[:, :2], min=1)).all()
        cap = frames.clamp(max=1000)[:, None]
        assert (w[:, 2:] <= torch.minimum(cap, torch.tensor(T_MAX))).all()
        assert (s[:, 2:] < torch.clamp(cap - w[:, 2:], min=1)).all()
    mel = torch.randn(2, 1000, 80)
    out = spec_augment_batch(mel, gen, torch.tensor([1000, 1000]), 2, 2)
    changed = out != mel
    assert changed.any() and (out[changed] == out[changed][0]).any()


def test_torch_dropout_rate_scaling_and_eval_noop():
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    y = residual_dropout(x, 0.1, True, gen)
    kept = y != 0
    # 200k Bernoulli(0.9) draws: the kept share is 0.9 within 5 sigma (0.0034)
    assert abs(kept.float().mean().item() - 0.9) < 0.0034
    np.testing.assert_allclose(y[kept].numpy(), 1 / 0.9, rtol=1e-6)
    assert residual_dropout(x, 0.1, False, gen) is x
    assert residual_dropout(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="Generator"):
        residual_dropout(x, 0.1, True, None)
    # the model: eval mode ignores dropout; train mode draws from the generator
    model, cfg = build_whisper_flamingo("test", add_gated_x_attn=0, use_av_hubert_encoder=False,
                                        dropout_rate=0.1, dtype="float32", device="cpu")
    mel, toks = torch.randn(1, 80, 40), torch.randint(0, 256, (1, 5))
    with torch.no_grad():
        a = model(mel, toks)
        b = model(mel, toks, generator=torch.Generator().manual_seed(1))
        model.train()
        c = model(mel, toks, generator=torch.Generator().manual_seed(1))
        d = model(mel, toks, generator=torch.Generator().manual_seed(1))
        e = model(mel, toks, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(c, d) and not torch.equal(c, e)


def test_torch_dataset_and_collator_match_jax():
    """Items and the collated batch: tokens, labels and frame counts exact,
    mel atol 5e-5 (the log-mel parity of tests/test_torch_logmel.py)."""
    from avsl_tpu.cli.finetune import make_synthetic_dataset
    from avsl_tpu.data.runtime import AmiVideoDataset as JaxDataset
    from avsl_tpu.data.runtime import WhisperVideoCollator as JaxCollator
    from avsl_tpu.data.tokenizer import get_tokenizer as jax_get_tokenizer
    from avsl_tpu_torch.data.runtime import AmiVideoDataset, WhisperVideoCollator
    from avsl_tpu_torch.data.tokenizer import get_tokenizer

    rows = make_synthetic_dataset(3, seconds=0.8)
    rows[1]["audio"]["array"] = (rows[1]["audio"]["array"] * 20000).astype(np.int16)
    rows[2]["transcript"] = "A  much LONGER, transcript; with <laugh> punctuation!"
    jtok, ptok = jax_get_tokenizer(None, "en"), get_tokenizer(None, "en")
    assert jtok.add_tokens(["<laugh>"]) == ptok.add_tokens(["<laugh>"])
    jds = JaxDataset(rows, jtok, audio_max_length=16000, load_video=False, train=True)
    pds = AmiVideoDataset(rows, ptok, audio_max_length=16000, load_video=False)
    assert len(pds) == len(jds) == 3
    for i in range(3):
        want, got = jds[i], pds[i]
        assert sorted(got) == sorted(want)
        np.testing.assert_allclose(got["input_ids"], want["input_ids"], atol=5e-5, rtol=1e-5)
        for key in ("dec_input_ids", "labels"):
            np.testing.assert_array_equal(got[key], want[key])
        assert got["audio_frames"] == want["audio_frames"]
    for cap in (None, 9):
        want = JaxCollator(eot_id=jtok.eot, max_label_len=cap)([jds[i] for i in range(3)])
        got = WhisperVideoCollator(eot_id=ptok.eot, max_label_len=cap)([pds[i] for i in range(3)])
        assert sorted(got) == sorted(want)
        for key in ("dec_input_ids", "labels", "audio_frames"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        np.testing.assert_allclose(got["input_ids"], want["input_ids"], atol=5e-5, rtol=1e-5)
    # a row without a lip clip gives one zero frame, as in JAX
    want = JaxDataset(rows, jtok, audio_max_length=16000, load_video=True)[0]["video"]
    got = AmiVideoDataset(rows, ptok, audio_max_length=16000, load_video=True)[0]["video"]
    assert got.shape == (1, 88, 88, 1)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def carried_fp32():
    """JAX tiny fp32 Whisper params with seeded noise on every leaf, and
    the port model (fp32 weights and compute, dropout 0) carrying them."""
    cfg = JaxWhisperConfig.tiny_test(dtype="float32")
    model = JaxWhisper(cfg)
    rng = np.random.default_rng(0)
    mel = rng.normal(size=(1, cfg.n_mels, 100)).astype(np.float32)
    toks = rng.integers(0, cfg.n_vocab, size=(1, 6)).astype(np.int32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(mel), jnp.asarray(toks))["params"]
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32), params)
    return cfg, model, params


def _port_model(params, n_audio_ctx, dtype="float32"):
    port, _ = build_whisper_flamingo("test", add_gated_x_attn=0, use_av_hubert_encoder=False,
                                     dtype=dtype, param_dtype="float32", device="cpu")
    port.load_state_dict(whisper_state_dict_from_flax(params, n_audio_ctx=n_audio_ctx))
    return port


def test_torch_bf16_compute_fp32_params_logits_match_jax(carried_fp32):
    """bf16 compute over fp32 weights in both packages (flax casts at use,
    the port too). atol 0.1 on logits of magnitude up to ~6: both round
    activations to bf16 (3 significant digits) after every projection, at
    different points (fused vs unfused bias adds, GELU), through 4 blocks;
    the logits product itself is fp32 over bf16-rounded operands in both."""
    cfg32, _, params = carried_fp32
    cfg = JaxWhisperConfig.tiny_test(dtype="bfloat16")
    assert cfg.param_dtype == "float32"
    model = JaxWhisper(cfg)
    rng = np.random.default_rng(5)
    mel = rng.normal(size=(2, cfg.n_mels, 100)).astype(np.float32)
    toks = rng.integers(0, cfg.n_vocab, size=(2, 7))
    want = np.asarray(model.apply({"params": params}, jnp.asarray(mel), jnp.asarray(toks)))
    port = _port_model(params, cfg.n_audio_ctx, dtype="bfloat16")
    assert all(p.dtype == torch.float32 for p in port.parameters())
    got = port(torch.from_numpy(mel), torch.from_numpy(toks))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=0.1)
    # an fp32-compute model on the same weights sits further away than the
    # bf16 models sit from each other
    fp32 = _port_model(params, cfg32.n_audio_ctx)
    with torch.no_grad():
        exact = fp32(torch.from_numpy(mel), torch.from_numpy(toks)).numpy()
    assert np.abs(got.detach().numpy() - want).mean() < np.abs(exact - want).mean()
    got.sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in port.parameters())


def _train_batches(cfg, n_steps, accum=2, micro=2, seed=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        labels = rng.integers(0, cfg.n_vocab, size=(accum, micro, 7))
        labels[:, :, 5:][rng.random((accum, micro, 2)) < 0.5] = -100
        out.append({
            "input_ids": rng.normal(size=(accum, micro, cfg.n_mels, 100)).astype(np.float32),
            "dec_input_ids": rng.integers(0, cfg.n_vocab, size=(accum, micro, 7)),
            "labels": labels,
        })
    return out


def _torch_grads(model):
    return {k: v for k, v in convert_whisper_state_dict(
        {n: p.grad.numpy() for n, p in model.named_parameters()}).items()}


def test_torch_train_step_matches_jax(carried_fp32):
    """Three accumulated steps (2 micro-batches of 2) of the port's train
    step against avsl_tpu.train.make_train_step on carried fp32 weights,
    dropout 0, no SpecAugment. Loss and grad_norm per step: rtol 2e-5
    (fp32, other summation order). Step-1 gradients: atol 2e-6 + rtol
    1e-4. Parameters after 3 steps: atol 2 x (sum of the learning rates),
    because Adam normalises each gradient element by its own history, so
    a 1e-9 difference in a near-zero gradient can become a full-lr step;
    and 99 % of the elements must agree within 1e-6."""
    cfg, model, params = carried_fp32
    tcfg = dict(learning_rate=1e-3, warmup_steps=1, num_train_steps=20, weight_decay=0.01)
    batches = _train_batches(cfg, 3)

    jax_loss = jax_flamingo_loss_fn(model, train=True)
    tx, _ = jax_whisper_optimizer(params, JaxTrainConfig(**tcfg), 20)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    jstep = jax_make_train_step(jax_loss, tx, grad_accum_steps=2, donate=False)

    port = _port_model(params, cfg.n_audio_ctx)
    opt, _ = whisper_optimizer(port, FlamingoTrainConfig(**tcfg), 20)
    pstate = TrainState.create(port, opt)
    ploss = flamingo_loss_fn(port, train=True)
    pstep = make_train_step(ploss, grad_accum_steps=2)

    # step-1 gradients, as the step accumulates them
    micros = [{k: jnp.asarray(v[i]) for k, v in batches[0].items()} for i in range(2)]
    want_g = jax.grad(lambda p: sum(
        jax_loss(p, None, m, jax.random.PRNGKey(0))[0] for m in micros) / 2)(jstate.params)
    for i in range(2):
        loss, _ = ploss({k: torch.as_tensor(v[i]) for k, v in batches[0].items()}, None)
        loss.backward()
    got_g = {k: v / 2 for k, v in _torch_grads(port).items()}
    want_g = _flatten(jax.device_get(want_g))
    assert sorted(got_g) == sorted(want_g)
    for key, w in want_g.items():
        np.testing.assert_allclose(got_g[key], w, atol=2e-6, rtol=1e-4, err_msg=key)
    port.zero_grad(set_to_none=True)

    lrs = []
    for i, batch in enumerate(batches):
        lrs.append(opt.learning_rate())
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, pm = pstep(pstate, batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=2e-5,
                                       err_msg=f"{key} step {i + 1}")
    assert lrs[0] == 0.0 and pstate.step == 3 and opt.count == 3
    got_p = convert_whisper_state_dict({n: p.detach().numpy() for n, p in port.named_parameters()})
    want_p = _flatten(jax.device_get(jstate.params))
    diffs = np.concatenate([np.abs(got_p[k] - w).ravel() for k, w in want_p.items()])
    assert diffs.max() <= 2 * sum(lrs), diffs.max()
    assert np.quantile(diffs, 0.99) <= 1e-6, np.quantile(diffs, 0.99)
