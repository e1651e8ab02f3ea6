"""The port's Flamingo fine-tuning CLI, serving what it trained, and the
audio-only entry point's loss (CPU).

* ``cli.finetune --smoke --device cpu``: the tiny Whisper-Flamingo model,
  6 steps of batch 4 x accumulation min(YAML, 2), towers in the loop by
  default; with ``freeze_video_batch_norm_stats: true`` and accumulation 2
  it takes the frozen-tower hoist; two devices without the launcher's
  ranks raise naming ``torch.distributed.run``, a missing dataset raises,
  and the default device is the card;
* ``--ckpt_dir`` round trip: the transcriber restored from the trained
  run's checkpoints gives the trained model's logits exactly (the same
  fp32 weights and BatchNorm statistics through the same operations), and
  an empty directory exits; ``TrainerRunner.test_best`` evaluates the
  pinned best checkpoint and puts the live weights back;
* ``whisper_ft``'s loss closure is ``flamingo_loss_fn(model, train=True)``
  without SpecAugment, as the JAX entry point's: on carried weights with
  dropout 0 it equals the JAX loss (rtol 2e-5) although the config asks
  for "ls-basic".
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import avsl_tpu_torch.train.runner as port_runner
from avsl_tpu.train.objectives import flamingo_loss_fn as jax_loss_fn
from avsl_tpu_torch.cli import _serving_common, finetune, transcribe, whisper_ft
from avsl_tpu_torch.core.config import FlamingoTrainConfig
from avsl_tpu_torch.data.tokenizer import get_tokenizer
from avsl_tpu_torch.train.checkpoints import restore_params_only
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)
from test_torch_train import _port_model, carried_fp32  # noqa: F401 (fixture)


def _yaml(tmp_path, **keys):
    keys = {"log_output_dir": str(tmp_path / "logs"),
            "check_output_dir": str(tmp_path / "ckpt"), **keys}
    path = tmp_path / "cfg.yaml"
    path.write_text("".join(f"{k}: {str(v).lower() if isinstance(v, bool) else v}\n"
                            for k, v in keys.items()))
    return str(path)


class _Recording(port_runner.TrainerRunner):
    made = []

    def __init__(self, loss_fn, *args, **kw):
        super().__init__(loss_fn, *args, **kw)
        self.loss_fn = loss_fn
        _Recording.made.append(self)


@pytest.fixture
def recording(monkeypatch):
    _Recording.made = []
    monkeypatch.setattr(port_runner, "TrainerRunner", _Recording)
    return _Recording.made


def test_torch_finetune_smoke_trains_on_cpu(tmp_path, monkeypatch, capsys, recording):
    """No YAML: the config's defaults (accumulation 16 capped at 2,
    BatchNorm on batch statistics), outputs under the working directory."""
    monkeypatch.chdir(tmp_path)
    result = finetune.main(["--smoke", "--device", "cpu"])
    assert result["final_step"] == 6 and result["hoisted"] is False
    assert "done: step=6" in capsys.readouterr().out
    (runner,) = recording
    assert runner.accum == 2 and runner.state.optimizer.count == 6
    trained = set(runner.state.optimizer.names)
    assert trained and all(("x_attn" in n or "x_mlp" in n or "video_projection" in n)
                           for n in trained)
    assert (tmp_path / "checkpoints" / "whisper_flamingo_ft" / "whisper-flamingo_ft_ami"
            / "step_6.pt").exists()
    # BatchNorm trained on batch statistics: the running ones moved
    stats = [b for n, b in runner.state.model.named_buffers() if n.endswith("running_var")]
    assert any(not bool((b == 1.0).all()) for b in stats)


def test_torch_finetune_smoke_hoists_with_frozen_batchnorm(tmp_path, recording):
    cfg = _yaml(tmp_path, freeze_video_batch_norm_stats=True, gradient_accumulation_steps=2)
    result = finetune.main([cfg, "--smoke", "--device", "cpu"])
    assert result["final_step"] == 6 and result["hoisted"] is True
    (runner,) = recording
    # frozen statistics never moved from their initial 0 means and unit variances
    stats = {n: b for n, b in runner.state.model.named_buffers() if "running_" in n}
    assert len(stats) == 40
    assert all(bool((b == (0.0 if n.endswith("mean") else 1.0)).all()) for n, b in stats.items())


def test_torch_finetune_refuses_what_is_not_ported(tmp_path):
    # without --smoke the datasets are read from disk: none there
    with pytest.raises(FileNotFoundError, match="train dataset not found"):
        finetune.main([_yaml(tmp_path, train_data_path=str(tmp_path / "none" / "train")),
                       "--device", "cpu"])
    # LoRA is ported (models/lora.py): it trains where it used to raise
    assert finetune.main([_yaml(tmp_path, lora_rank=4), "--smoke", "--device", "cpu"]
                         )["final_step"] == 6
    # a mesh is ported (core/mesh.py): 2 devices need 2 ranks of the launcher
    with pytest.raises(RuntimeError, match="torch.distributed.run --nproc_per_node 2"):
        finetune.main([_yaml(tmp_path, num_devices=2), "--smoke", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            finetune.main([_yaml(tmp_path), "--smoke"])


def test_torch_ckpt_dir_round_trip(tmp_path, recording):
    """Train, then serve the checkpoint: the transcriber's model gives the
    trained model's logits; an empty directory exits."""
    cfg_path = _yaml(tmp_path, freeze_video_batch_norm_stats=False)
    finetune.main([cfg_path, "--smoke", "--device", "cpu"])
    trained = recording[0].state.model.eval()
    cfg = FlamingoTrainConfig.from_yaml(cfg_path)
    cfg.model_name, cfg.audio_max_length = "test", 16000
    ckpt_dir = str(tmp_path / "ckpt" / cfg.train_id)
    served, _ = _serving_common.build_target_model(cfg, get_tokenizer(None, "en"), True,
                                                   ckpt_dir, device="cpu")
    random, _ = _serving_common.build_target_model(cfg, get_tokenizer(None, "en"), True, None,
                                                   device="cpu")
    assert not served.training
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.normal(size=(2, 80, 100)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, 200, size=(2, 5)))
    video = torch.from_numpy(rng.normal(size=(2, 4, 88, 88, 1)).astype(np.float32))
    with torch.no_grad():
        want = trained(mel, toks, video)
        assert torch.equal(served(mel, toks, video), want)
        assert not torch.allclose(random(mel, toks, video), want)
    with pytest.raises(SystemExit, match="no checkpoint"):
        _serving_common.build_target_model(cfg, get_tokenizer(None, "en"), True,
                                           str(tmp_path / "empty"), device="cpu")
    # the CLI serves it end to end
    import scipy.io.wavfile as wavfile

    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    wavfile.write(wav_dir / "a.wav", 16000, (0.1 * rng.standard_normal(12000)).astype(np.float32))
    out = transcribe.main(["--input", str(wav_dir), "--smoke", "--device", "cpu",
                           "--ckpt_dir", ckpt_dir, "--max_new_tokens", "4"])
    assert [r["id"] for r in out] == ["a"]

    # test_best evaluates the pinned best checkpoint, then puts the live weights back
    runner = recording[0]
    tokenizer = get_tokenizer(None, "en")
    tokenizer.add_tokens(["<laugh>"])
    val_ds = finetune.make_dataset(finetune.make_synthetic_dataset(2), tokenizer, cfg,
                                   trained.cfg, train=False)
    collator = finetune.make_collator(tokenizer, cfg, trained.cfg)
    seen, evaluate = [], runner.eval_logits_fn

    def spy(state, batch):
        seen.append(state.model.video_projection.weight.detach().clone())
        return evaluate(state, batch)

    runner.eval_logits_fn = spy
    live = {k: v.clone() for k, v in trained.state_dict().items()}
    metrics = runner.test_best(lambda: whisper_ft.batches(val_ds, collator, 1, False))
    best = restore_params_only(runner._best_dir, runner.best_step)
    assert "test/wer_av" in metrics and len(seen) == 2
    assert all(torch.equal(w, best["video_projection.weight"]) for w in seen)
    assert all(torch.equal(v, live[k]) for k, v in trained.state_dict().items())


def test_torch_whisper_ft_loss_has_no_spec_augment(carried_fp32, tmp_path, recording):  # noqa: F811
    cfg32, jmodel, params = carried_fp32
    port = _port_model(params, cfg32.n_audio_ctx)
    cfg = FlamingoTrainConfig(spec_augment="ls-basic", num_train_steps=4)
    whisper_ft.make_runner(cfg, port, get_tokenizer(None, "en"), str(tmp_path))
    rng = np.random.default_rng(4)
    batch = {"input_ids": rng.normal(size=(2, cfg32.n_mels, 100)).astype(np.float32),
             "dec_input_ids": rng.integers(0, cfg32.n_vocab, size=(2, 6)),
             "labels": rng.integers(0, cfg32.n_vocab, size=(2, 6))}
    want, _ = jax_loss_fn(jmodel, train=True)(params, None,
                                               {k: jnp.asarray(v) for k, v in batch.items()},
                                               jax.random.PRNGKey(0))
    with torch.no_grad():
        got, _ = recording[0].loss_fn({k: torch.as_tensor(v) for k, v in batch.items()},
                                      torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(got), float(want), rtol=2e-5)
