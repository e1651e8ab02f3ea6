"""The port's evaluation entry point against the JAX package's (CPU).

* ``cli.evaluate --smoke --beam 2 --device cpu`` runs the tiny fp32 model
  on four synthetic rows and reports the teacher-forced and beam metrics;
  the default device is the card;
* parity: the JAX tiny Whisper-Flamingo model's weights (noise on every
  leaf, gates nonzero) carried into the port; on the same rows (lip clips
  written as mp4, one row dropped with the last partial batch) the port's
  ``evaluate`` and what ``avsl_tpu/cli/evaluate.py`` runs (``evaluate_wer``
  over its jitted teacher-forced logits, then its KV-cached
  ``beam_search``) give equal WER, CER and beam WER/CER, the loss within
  rtol 1e-4, and identical beam hypotheses batch by batch;
* ``--ckpt_dir``: a ``cli.finetune --smoke`` run's checkpoint restored by
  ``cli.evaluate`` gives the trained model's metrics exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.data.runtime import AmiVideoDataset as JaxDataset
from avsl_tpu.data.runtime import WhisperVideoCollator as JaxCollator
from avsl_tpu.data.tokenizer import get_tokenizer as jax_get_tokenizer
from avsl_tpu.decode import beam_search as jax_beam_search
from avsl_tpu.decode import normalize_text as jax_normalize
from avsl_tpu.decode import wer_cer as jax_wer_cer
from avsl_tpu.train.runner import evaluate_wer as jax_evaluate_wer
from avsl_tpu_torch.cli import evaluate as port_eval
from avsl_tpu_torch.cli import finetune
from avsl_tpu_torch.core.config import FlamingoTrainConfig
from avsl_tpu_torch.data.runtime import WhisperVideoCollator
from avsl_tpu_torch.data.tokenizer import get_tokenizer
from avsl_tpu_torch.data.video_io import write_video_frames
from avsl_tpu.core.config import AVHuBERTConfig as JaxAVHuBERTConfig
from avsl_tpu.models.factory import build_whisper_flamingo as jax_build
from avsl_tpu_torch.core.config import AVHuBERTConfig
from avsl_tpu_torch.models import build_whisper_flamingo, whisper_state_dict_from_flax
from test_torch_flamingo_common import ZERO_RATES, noisy_av_variables
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)

BEAM, MAX_NEW = 2, 8
LOSS_RTOL = 1e-4


def _cfg(batch: int = 2):
    cfg = FlamingoTrainConfig()
    cfg.model_name, cfg.audio_max_length, cfg.eval_batch_size = "test", 16000, batch
    return cfg


def _rows(tmp_path, n: int = 5):
    """``n`` rows of seeded 1 s audio, transcripts, and seeded 96 x 96 lip
    clips of 10-22 frames written as mp4 (row 1 has none)."""
    rng = np.random.default_rng(7)
    rows = []
    for i in range(n):
        lip = None
        if i != 1:
            lip = str(tmp_path / f"lip{i}.mp4")
            write_video_frames(lip, rng.integers(0, 256, (10 + 3 * i, 96, 96), dtype=np.uint8))
        rows.append({"audio": {"array": (0.1 * rng.standard_normal(16000)).astype(np.float32),
                               "sampling_rate": 16000},
                     "transcript": f"the meeting item number {i}", "duration": 1.0,
                     "lip_video": lip})
    return rows


def test_torch_evaluate_smoke_on_cpu(capsys):
    out = port_eval.main(["--smoke", "--beam", "2", "--max_new_tokens", "6", "--device", "cpu"])
    for key in ("test/wer_av", "test/cer_av", "test/loss", "test/wer_beam", "test/cer_beam"):
        assert key in out and np.isfinite(out[key]), key
    assert '"test/wer_beam"' in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_eval.main(["--smoke"])


def _carried(vocab: int, seed: int = 4):
    """(jax model, variables, port model): the tiny fp32 Whisper-Flamingo
    at the tokenizer's vocab, as both evaluation CLIs build it, on the same
    noisy weights (tower rates 0, gates nonzero)."""
    model, cfg = jax_build("test", vocab_size=vocab, add_gated_x_attn=1,
                           use_av_hubert_encoder=True,
                           av_hubert_cfg=JaxAVHuBERTConfig.tiny_test(dtype="float32", **ZERO_RATES),
                           dtype="float32")
    rng = np.random.default_rng(seed)
    mel = jnp.asarray(rng.normal(size=(2, cfg.n_mels, 100)).astype(np.float32))
    toks = jnp.asarray(rng.integers(0, vocab, size=(2, 6)).astype(np.int32))
    video = jnp.asarray(rng.normal(size=(2, 6, 48, 48, 1)).astype(np.float32))
    variables = noisy_av_variables(
        jax.jit(lambda k, m, t, v: model.init(k, m, t, video=v))(
            jax.random.PRNGKey(0), mel, toks, video), rng)
    port, _ = build_whisper_flamingo(
        "test", vocab_size=vocab, add_gated_x_attn=1, use_av_hubert_encoder=True,
        av_hubert_cfg=AVHuBERTConfig.tiny_test(dtype="float32", **ZERO_RATES),
        dtype="float32", param_dtype="float32", device="cpu")
    port.load_state_dict(whisper_state_dict_from_flax(
        variables["params"], n_audio_ctx=cfg.n_audio_ctx, batch_stats=variables["batch_stats"]))
    return model, variables, port


def _jax_evaluate(model, variables, cfg, rows):
    """``avsl_tpu/cli/evaluate.py``'s two modes on given variables:
    ``(results, [beam token rows per batch])``."""
    tokenizer = jax_get_tokenizer(None, cfg.lang)
    tokenizer.add_tokens(["<laugh>"])
    w_cfg = model.cfg
    ds = JaxDataset(rows, tokenizer, audio_max_length=int(cfg.audio_max_length),
                    n_mels=w_cfg.n_mels, lang=cfg.lang, load_video=True)
    collator = JaxCollator(eot_id=tokenizer.eot, max_label_len=w_cfg.n_text_ctx)
    bs = int(cfg.eval_batch_size)

    def batches():
        for i in range(0, len(ds) - bs + 1, bs):
            yield collator([ds[j] for j in range(i, i + bs)])

    eval_logits = jax.jit(lambda b: model.apply(
        variables, b["input_ids"], b["dec_input_ids"], video=b.get("video"), deterministic=True))
    results = jax_evaluate_wer(eval_logits, batches(), tokenizer, prefix="test")

    def decode_batch(batch, prompt):
        feats, xv = model.apply(variables, batch["input_ids"], batch.get("video"),
                                method=model.encode)
        cache = model.apply(variables, feats, xv, MAX_NEW + 6, method=model.init_decode_cache)

        def step(tok, cache):
            return model.apply(variables, tok, None, None, cache, method=model.decode)

        return jax_beam_search(step, cache, prompt, BEAM, MAX_NEW, tokenizer.eot)

    special = tokenizer.special_token_set
    hyps, refs, seqs_all = [], [], []
    for batch in batches():
        prompt = np.tile(np.asarray(tokenizer.sot_sequence(cfg.lang))[None],
                         (batch["input_ids"].shape[0], 1))
        seqs, _ = jax.jit(decode_batch)(batch, jnp.asarray(prompt))
        seqs_all.append(np.asarray(seqs))
        for o_row, l_row in zip(np.asarray(seqs), batch["labels"]):
            hyps.append(jax_normalize(tokenizer.decode([int(t) for t in o_row
                                                        if int(t) not in special])))
            refs.append(jax_normalize(tokenizer.decode(
                [int(t) for t in l_row if int(t) >= 0 and int(t) not in special])))
    results["test/wer_beam"], results["test/cer_beam"] = jax_wer_cer(hyps, refs)
    return results, seqs_all


def test_torch_evaluate_matches_jax_on_carried_weights(tmp_path):
    cfg, rows = _cfg(), _rows(tmp_path)
    tokenizer = get_tokenizer(None, cfg.lang)
    model, variables, port = _carried(tokenizer.add_tokens(["<laugh>"]))
    want, want_seqs = _jax_evaluate(model, variables, cfg, rows)

    got = port_eval.evaluate(cfg, port, tokenizer, rows, beam=BEAM, max_new_tokens=MAX_NEW)
    assert sorted(got) == sorted(want)
    for key in ("test/wer_av", "test/cer_av", "test/wer_beam", "test/cer_beam"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["test/loss"], want["test/loss"], rtol=LOSS_RTOL)

    # the beam hypotheses themselves, batch by batch (the last partial batch dropped)
    ds = finetune.make_dataset(rows, tokenizer, cfg, port.cfg, train=False)
    collator = WhisperVideoCollator(eot_id=tokenizer.eot, max_label_len=port.cfg.n_text_ctx)
    batches = list(port_eval.eval_batches(ds, collator, cfg.eval_batch_size))
    assert len(batches) == len(want_seqs) == len(rows) // cfg.eval_batch_size
    sot = np.asarray(tokenizer.sot_sequence(cfg.lang))
    port.eval()
    for batch, want_b in zip(batches, want_seqs):
        prompt = np.tile(sot[None], (batch["input_ids"].shape[0], 1))
        seqs = port_eval.beam_decode_batch(port, batch, prompt, BEAM, MAX_NEW, tokenizer.eot)
        np.testing.assert_array_equal(seqs.numpy(), want_b)


def test_torch_evaluate_restores_ckpt_dir(tmp_path):
    """``cli.evaluate --ckpt_dir`` on a ``cli.finetune --smoke`` run gives
    the trained model's metrics exactly; the model's mode is restored."""
    import yaml

    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump({"log_output_dir": str(tmp_path / "logs"),
                                        "check_output_dir": str(tmp_path / "ckpt"),
                                        "freeze_video_batch_norm_stats": False}))
    recorded = []
    real_make_job = finetune.make_job

    def make_job(*a, **k):
        job = real_make_job(*a, **k)
        recorded.append(job)
        return job

    finetune.make_job = make_job
    try:
        finetune.main([str(cfg_path), "--smoke", "--device", "cpu"])
    finally:
        finetune.make_job = real_make_job
    trained = recorded[0].runner.state.model
    cfg = FlamingoTrainConfig.from_yaml(str(cfg_path))
    ckpt_dir = str(tmp_path / "ckpt" / cfg.train_id)
    got = port_eval.main(["--config", str(cfg_path), "--smoke", "--device", "cpu",
                          "--ckpt_dir", ckpt_dir])
    cfg.model_name, cfg.audio_max_length, cfg.eval_batch_size = "test", 16000, 4
    tokenizer = get_tokenizer(None, cfg.lang)
    tokenizer.add_tokens(["<laugh>"])
    trained.train()
    want = port_eval.evaluate(cfg, trained, tokenizer, finetune.make_synthetic_dataset(4))
    assert trained.training
    assert got == want
