"""The port's audio-only fine-tuning entry point, its checkpoints and its
beam search (CPU).

``whisper_ft.main(["--smoke", "--device", "cpu"])`` trains the tiny model
with batch 1 x accumulation 2 and runs the beam-search eval; a train
state survives a save/restore round trip; and the port's beam search
matches ``avsl_tpu.decode.beam_search`` on carried weights (tokens exact,
scores atol 1e-4: fp32 log-probabilities summed over up to 8 steps in
another order).
"""

import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.core.config import WhisperConfig as JaxWhisperConfig
from avsl_tpu.decode import beam_search as jax_beam_search
from avsl_tpu.models import Whisper as JaxWhisper
from avsl_tpu_torch.cli import whisper_ft
from avsl_tpu_torch.core.config import FlamingoTrainConfig
from avsl_tpu_torch.decode.beam import beam_search
from avsl_tpu_torch.models import build_whisper_flamingo, whisper_state_dict_from_flax
from avsl_tpu_torch.train import TrainState, flamingo_loss_fn, make_train_step, whisper_optimizer
from avsl_tpu_torch.train.checkpoints import (
    all_steps,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)


def test_torch_whisper_ft_smoke_trains_with_accumulation_and_beam_evals(tmp_path):
    out = tmp_path / "wft"
    results = whisper_ft.main(["--smoke", "--device", "cpu", "--num_beams", "2",
                               "--output_dir", str(out)])
    # batch 1 x accumulation 2: every train batch holds 2 items and steps
    assert results["train"]["final_step"] == 4
    assert results["eval"]["n"] == 4 and 0.0 <= results["eval"]["cer"]
    assert json.loads((out / "results.json").read_text()) == results
    logged = [json.loads(line) for line in (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert logged[-1]["step"] == 4 and math.isfinite(logged[-1]["train/loss"])
    assert latest_step(str(out / "ckpt")) == 4


def test_torch_whisper_ft_refuses_real_datasets_and_missing_cuda(tmp_path):
    with pytest.raises(NotImplementedError, match="item 13"):
        whisper_ft.main(["--device", "cpu", "--do_train", "--output_dir", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            whisper_ft.main(["--smoke", "--output_dir", str(tmp_path)])


def _tiny_state(seed=0):
    model, cfg = build_whisper_flamingo("test", add_gated_x_attn=0, use_av_hubert_encoder=False,
                                        dropout_rate=0.1, dtype="float32", param_dtype="float32",
                                        device="cpu", seed=seed)
    tcfg = FlamingoTrainConfig(learning_rate=1e-3, warmup_steps=1, num_train_steps=10)
    opt, _ = whisper_optimizer(model, tcfg, 10)
    return TrainState.create(model, opt, seed=seed), cfg


def test_torch_checkpoint_round_trip(tmp_path):
    state, cfg = _tiny_state()
    step = make_train_step(flamingo_loss_fn(state.model, train=True, spec_augment="ls-basic"),
                           grad_accum_steps=2)
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.normal(size=(2, 1, cfg.n_mels, 60)).astype(np.float32),
             "dec_input_ids": rng.integers(0, cfg.n_vocab, size=(2, 1, 5)),
             "labels": rng.integers(0, cfg.n_vocab, size=(2, 1, 5)),
             "audio_frames": np.full((2, 1), 60, np.int32)}
    for i in range(2):
        state, _ = step(state, batch)
        save_checkpoint(str(tmp_path), state, state.step, max_to_keep=1)
    assert all_steps(str(tmp_path)) == [2]

    fresh, _ = _tiny_state(seed=1)
    assert not torch.equal(fresh.model.decoder.token_embedding.weight,
                           state.model.decoder.token_embedding.weight)
    restore_checkpoint(str(tmp_path), fresh)
    assert fresh.step == 2 and fresh.optimizer.count == 2
    for (name, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(state.optimizer.mu + state.optimizer.nu, fresh.optimizer.mu + fresh.optimizer.nu):
        assert torch.equal(a, b)
    assert torch.equal(state.generator.get_state(), fresh.generator.get_state())
    # the restored state continues exactly as the saved one does
    _, m1 = step(state, batch)
    _, m2 = make_train_step(flamingo_loss_fn(fresh.model, train=True, spec_augment="ls-basic"),
                            grad_accum_steps=2)(fresh, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), fresh)


@pytest.mark.parametrize("beam_size", [1, 3])
def test_torch_beam_search_matches_jax(beam_size):
    cfg = JaxWhisperConfig.tiny_test(dtype="float32")
    model = JaxWhisper(cfg)
    rng = np.random.default_rng(3)
    mel = rng.normal(size=(2, cfg.n_mels, 100)).astype(np.float32)
    prompt = np.tile(np.asarray([[250, 251, 252]], np.int32), (2, 1))
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(mel), jnp.asarray(prompt))["params"]
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32), params)
    v = {"params": params}
    max_new = 8
    feats, _ = model.apply(v, jnp.asarray(mel), method=model.encode)
    # EOT: the first choice of item 0, so that some beams finish at once
    first = model.apply(v, jnp.asarray(prompt), feats, method=model.decode)[0][:, -1]
    eot = int(jnp.argmax(first[0]))
    cache = model.apply(v, feats, None, max_new + 5, method=model.init_decode_cache)

    def jstep(tok, c):
        return model.apply(v, tok, feats, None, c, method=model.decode)

    want_seq, want_score = jax_beam_search(jstep, cache, jnp.asarray(prompt), beam_size=beam_size,
                                           max_new_tokens=max_new, eot_id=eot)

    port, _ = build_whisper_flamingo("test", add_gated_x_attn=0, use_av_hubert_encoder=False,
                                     dtype="float32", device="cpu")
    port.load_state_dict(whisper_state_dict_from_flax(params, n_audio_ctx=cfg.n_audio_ctx))
    with torch.inference_mode():
        pf, _ = port.encode(torch.from_numpy(mel))
        pc = port.init_decode_cache(pf, None, max_new + 5)
        got_seq, got_score = beam_search(lambda tok, c: port.decode(tok, None, None, c), pc,
                                         torch.from_numpy(prompt).long(), beam_size=beam_size,
                                         max_new_tokens=max_new, eot_id=eot)
        got_nbest, got_nscores = beam_search(
            lambda tok, c: port.decode(tok, None, None, c),
            port.init_decode_cache(pf, None, max_new + 5), torch.from_numpy(prompt).long(),
            beam_size=beam_size, max_new_tokens=max_new, eot_id=eot, return_nbest=True)
    np.testing.assert_array_equal(got_seq.numpy(), np.asarray(want_seq))
    np.testing.assert_allclose(got_score.numpy(), np.asarray(want_score), atol=1e-4)
    want_nbest, want_nscores = jax_beam_search(
        jstep, cache, jnp.asarray(prompt), beam_size=beam_size, max_new_tokens=max_new,
        eot_id=eot, return_nbest=True)
    np.testing.assert_array_equal(got_nbest.numpy(), np.asarray(want_nbest))
    np.testing.assert_allclose(got_nscores.numpy(), np.asarray(want_nscores), atol=1e-4)
    assert (got_nbest.numpy() == eot).any()  # some hypotheses finished early


def test_torch_eval_step_is_the_deterministic_loss():
    """make_eval_step: no gradients, no random draws (dropout 0.1 and
    SpecAugment off in eval), equal to the CE of the eval-mode logits."""
    from avsl_tpu_torch.models.avhubert import cross_entropy_loss
    from avsl_tpu_torch.train import make_eval_step

    state, cfg = _tiny_state()
    rng = np.random.default_rng(1)
    batch = {"input_ids": rng.normal(size=(2, cfg.n_mels, 60)).astype(np.float32),
             "dec_input_ids": rng.integers(0, cfg.n_vocab, size=(2, 5)),
             "labels": rng.integers(0, cfg.n_vocab, size=(2, 5))}
    evaluate = make_eval_step(flamingo_loss_fn(state.model, train=False, spec_augment="ls-basic"))
    first, second = evaluate(state, batch)["loss"], evaluate(state, batch)["loss"]
    assert first.grad_fn is None and float(first) == float(second)
    with torch.no_grad():
        logits = state.model.eval()(torch.from_numpy(batch["input_ids"]),
                                    torch.from_numpy(batch["dec_input_ids"]))
    want = cross_entropy_loss(logits, torch.from_numpy(batch["labels"]))
    assert float(first) == float(want)
