"""Draft distillation of the port (``train/distill.py``, ``cli/distill.py``)
against the JAX package (CPU, fp32).

The cases of ``tests/test_distill.py``, on the tiny audio-only presets
(vocab 64, EOT 63): ``valid_positions`` equal to JAX's; the label
function's shapes and mask; ``distill_loss_fn``'s loss, kl, ce and agree
and the draft's gradients against JAX's with the JAX weights carried in
(atol 1e-5, rtol 1e-4); 3 ``make_online_distill_step`` steps against
JAX's with ``optax.adamw`` (metrics rtol 1e-4; the draft atol 1e-4, a
tenth of the learning rate: Adam normalises the near-zero gradients of
the cross-attention keys, where fp32 rounding moves an update most), the
result carried back through the JAX converter giving JAX the port's loss;
distillation raising ``agree`` and the speculative acceptance with
greedy's tokens unchanged (60 steps, where JAX's test runs up to 300);
and ``cli.distill --smoke --device cpu`` followed by ``cli.transcribe
--draft_model test --draft_ckpt``, with the same transcripts as without a
draft and the wrong preset refused.
"""

import numpy as np
import optax
import pytest
import scipy.io.wavfile as wavfile
import torch

import flax.traverse_util as traverse_util
import jax
import jax.numpy as jnp

from avsl_tpu.models.convert import convert_whisper_state_dict
from avsl_tpu.models.factory import build_whisper_flamingo as jax_build
from avsl_tpu.train import distill as jdistill
from avsl_tpu.train.loop import TrainState as JaxTrainState
from avsl_tpu_torch.decode.greedy import greedy_decode
from avsl_tpu_torch.decode.speculative import speculative_greedy_decode
from avsl_tpu_torch.kernels.logmel import log_mel_spectrogram
from avsl_tpu_torch.models import build_whisper_flamingo, state_dict_from_flax
from avsl_tpu_torch.models import whisper_state_dict_from_flax
from avsl_tpu_torch.train import distill
from avsl_tpu_torch.train.loop import TrainState
from avsl_tpu_torch.train.optim import constant_adamw
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)

EOT, VOCAB = 63, 64
TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def models():
    """(jax target, vars, jax draft, vars, port target, port draft, audio,
    prompt): the tiny audio-only preset twice, JAX-initialised, carried."""
    jt, t_cfg = jax_build("test", vocab_size=VOCAB, add_gated_x_attn=False, dtype="float32")
    jd, _ = jax_build("test", vocab_size=VOCAB, add_gated_x_attn=False, dtype="float32")
    b, s = 4, 16000
    audio = (0.1 * np.random.default_rng(0).standard_normal((b, s))).astype(np.float32)
    zeros = (np.zeros((b, t_cfg.n_mels, s // 160), np.float32), np.zeros((b, 4), np.int32))
    t_vars = jax.jit(jt.init)(jax.random.PRNGKey(0), *zeros)
    d_vars = jax.jit(jd.init)(jax.random.PRNGKey(5), *zeros)

    def port(variables):
        m, _ = build_whisper_flamingo("test", vocab_size=VOCAB, add_gated_x_attn=0,
                                      dtype="float32", param_dtype="float32", device="cpu")
        m.load_state_dict(whisper_state_dict_from_flax(variables["params"],
                                                       n_audio_ctx=t_cfg.n_audio_ctx))
        return m.eval()

    prompt = np.tile(np.asarray([[1, 2, 3]], np.int32), (b, 1))
    return jt, t_vars, jd, d_vars, port(t_vars), port(d_vars), audio, prompt


def test_torch_valid_positions_match_jax():
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 8, size=(6, 12))
    tokens[:, :3] = [1, 2, 3]
    for eot in (5, 7):
        want = np.asarray(jdistill.valid_positions(jnp.asarray(tokens), 3, eot))
        got = distill.valid_positions(torch.as_tensor(tokens), 3, eot).numpy()
        np.testing.assert_array_equal(got, want)


def test_torch_label_fn_matches_jax_and_masks(models):
    jt, t_vars, _, _, target, _, audio, prompt = models
    tokens, t_logprob, valid = distill.make_label_fn(target, 6, EOT)(audio, prompt)
    jtokens, jlogprob, jvalid = jdistill.make_label_fn(jt, t_vars, 6, EOT)(audio, prompt)
    b, p = prompt.shape
    assert tokens.shape == (b, p + 6) and t_logprob.shape == (b, p + 5, VOCAB)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
    np.testing.assert_allclose(t_logprob.numpy(), np.asarray(jlogprob), **TOL)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    v = valid.numpy()
    assert not v[:, : p - 1].any() and v[:, p - 1].all()


def _labelled(models):
    jt, t_vars, *_, audio, prompt = models
    tokens, t_logprob, valid = jdistill.make_label_fn(jt, t_vars, 8, EOT)(audio, prompt)
    return np.asarray(tokens), np.asarray(t_logprob), np.asarray(valid)


def test_torch_distill_loss_and_grads_match_jax(models):
    _, _, jd, d_vars, _, draft, audio, _ = models
    tokens, t_logprob, valid = _labelled(models)

    def jloss(params):
        return jdistill.distill_loss_fn(jd, params, {}, jnp.asarray(audio), jnp.asarray(tokens),
                                        jnp.asarray(t_logprob), jnp.asarray(valid))

    (_, want), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(d_vars["params"])
    draft.zero_grad()
    loss, got = distill.distill_loss_fn(draft, audio, torch.as_tensor(tokens),
                                        torch.as_tensor(t_logprob), torch.as_tensor(valid))
    loss.backward()
    for key in ("loss", "kl", "ce", "agree"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), err_msg=key, **TOL)
    grads = state_dict_from_flax(jax.device_get(want_g))
    named = dict(draft.named_parameters())
    assert set(grads) == set(named)
    for key, g in grads.items():
        np.testing.assert_allclose(named[key].grad.numpy(), g.numpy(), err_msg=key, **TOL)
    draft.zero_grad()


def test_torch_online_distill_steps_match_jax(models):
    jt, t_vars, jd, d_vars, target, draft0, audio, prompt = models
    tokens, _, _ = _labelled(models)
    tx = optax.adamw(1e-3, weight_decay=0.01)
    jstate = JaxTrainState.create(d_vars["params"], tx)
    jstep = jdistill.make_online_distill_step(jt, t_vars, jd, tx, prompt_len=3, eot_id=EOT)
    draft, _ = build_whisper_flamingo("test", vocab_size=VOCAB, add_gated_x_attn=0,
                                      dtype="float32", param_dtype="float32", device="cpu")
    draft.load_state_dict(draft0.state_dict())
    state = TrainState.create(draft, constant_adamw(dict(draft.named_parameters()), 1e-3))
    step = distill.make_online_distill_step(target, draft, prompt_len=3, eot_id=EOT)
    for i in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(audio), jnp.asarray(tokens))
        state, m = step(state, audio, tokens)
        for key in ("loss", "kl", "ce", "agree"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{key} step {i + 1}")
    assert state.step == 3 and state.optimizer.count == 3
    want = state_dict_from_flax(jax.device_get(jstate.params))
    named = dict(draft.named_parameters())
    for key, w in want.items():
        np.testing.assert_allclose(named[key].detach().numpy(), w.numpy(), atol=1e-4, rtol=0,
                                   err_msg=key)
    # and back: JAX's loss on the port's trained draft is the port's
    back = {k: v.numpy() for k, v in draft.state_dict().items()}
    params = traverse_util.unflatten_dict(convert_whisper_state_dict(back), sep="/")
    t_lp = jdistill.make_label_fn(jt, t_vars, 8, EOT)(audio, prompt)
    jl, _ = jdistill.distill_loss_fn(jd, params, {}, jnp.asarray(audio), *t_lp)
    pl, _ = distill.distill_loss_fn(draft, audio, *(torch.as_tensor(np.asarray(x)) for x in t_lp))
    np.testing.assert_allclose(float(pl), float(jl), **TOL)


def test_torch_distill_raises_acceptance_tokens_stay_greedy(models):
    *_, target, draft0, audio, prompt = models
    max_new, k = 8, 3
    tokens, t_logprob, valid = distill.make_label_fn(target, max_new, EOT)(audio, prompt)
    draft, _ = build_whisper_flamingo("test", vocab_size=VOCAB, add_gated_x_attn=0,
                                      dtype="float32", param_dtype="float32", device="cpu")
    draft.load_state_dict(draft0.state_dict())
    random = {k2: v.clone() for k2, v in draft.state_dict().items()}
    state = TrainState.create(draft, constant_adamw(dict(draft.named_parameters()), 3e-3,
                                                    weight_decay=0.0))
    step = distill.make_distill_step(draft, hard_weight=0.5)
    with torch.no_grad():
        loss0, m0 = distill.distill_loss_fn(draft, audio, tokens, t_logprob, valid)
    metrics = m0
    for _ in range(60):
        state, metrics = step(state, audio, tokens, t_logprob, valid)
        if float(metrics["agree"]) > 0.95:
            break
    agree0, agree1 = float(m0["agree"]), float(metrics["agree"])
    assert agree1 > max(0.8, agree0 + 0.2), (agree0, agree1)
    assert float(metrics["loss"]) < float(loss0)

    def spec_run(weights):
        draft.load_state_dict(weights)
        with torch.no_grad():
            mel = log_mel_spectrogram(torch.as_tensor(audio), n_mels=target.cfg.n_mels)
            feats, _ = target.encode(mel)
            dfeats, _ = draft.encode(mel)
            need = prompt.shape[1] + max_new + k
            p = torch.as_tensor(prompt).long()

            def st(t, c):
                return target.decode(t, None, cache=c)

            def sd(t, c):
                return draft.decode(t, None, cache=c)

            ref = greedy_decode(st, target.init_decode_cache(feats, None, need), p, max_new, EOT)
            res = speculative_greedy_decode(st, sd, target.init_decode_cache(feats, None, need),
                                            draft.init_decode_cache(dfeats, None, need), p,
                                            max_new, EOT, k=k)
        assert torch.equal(res.tokens, ref)
        return float(res.accept_rate)

    trained = {k2: v.clone() for k2, v in draft.state_dict().items()}
    acc_random, acc_distilled = spec_run(random), spec_run(trained)
    assert acc_distilled > acc_random + 0.3 and acc_distilled > 0.6, (acc_random, acc_distilled)


def test_torch_cli_distill_to_transcribe_roundtrip(tmp_path, monkeypatch):
    import json
    import os

    from avsl_tpu_torch.cli import distill as distill_cli
    from avsl_tpu_torch.cli import transcribe

    seg_dir = tmp_path / "segs"
    seg_dir.mkdir()
    for i in range(3):
        x = 0.2 * np.sin(2 * np.pi * (180 + 90 * i) * np.arange(16000) / 16000)
        wavfile.write(str(seg_dir / f"seg{i}.wav"), 16000, (x * 32767).astype(np.int16))
    monkeypatch.chdir(tmp_path)
    out_dir = str(tmp_path / "draft_ckpt")
    with pytest.raises(SystemExit, match="--ckpt_dir required"):
        distill_cli.main(["--input", str(seg_dir), "--output", out_dir, "--device", "cpu"])
    summary = distill_cli.main(["--input", str(seg_dir), "--smoke", "--device", "cpu",
                                "--output", out_dir, "--steps", "3", "--batch_size", "2",
                                "--max_new_tokens", "4", "--log_every", "1"])
    assert json.load(open(os.path.join(out_dir, "distill_summary.json"))) == summary
    assert summary["final"]["loss"] >= 0.0 and len(summary["history"]) == 3
    common = ["--input", str(seg_dir), "--smoke", "--device", "cpu", "--batch_size", "2",
              "--max_new_tokens", "4"]
    base = transcribe.main(common)
    spec = transcribe.main(common + ["--draft_model", "test", "--draft_ckpt", out_dir,
                                     "--spec_k", "2"])
    assert [r["text"] for r in spec] == [r["text"] for r in base]
    with pytest.raises(SystemExit, match="does not match"):
        transcribe.main(common + ["--draft_model", "tiny", "--draft_ckpt", out_dir])
