"""The port's training CLIs on a dataset on disk, without ``--smoke`` (CPU).

A train/val/test tree (``tests/torch_dataset_fixtures.py``: 8, 4 and 4
rows of 0.3-0.65 s, no lip clips) and one YAML (the tiny Whisper-Flamingo
model, fp32, batch 2, accumulation 2, 2 optimizer steps, validation every
2 micro-batches, BatchNorm frozen, which would hoist the towers under
``--smoke``) go through ``avsl_tpu_torch.cli.finetune.main([yaml,
"--device", "cpu"])`` and ``avsl_tpu.cli.finetune.main([yaml])``. Both
report ``final_step`` = 2 × 2 micro-batches, validate at the same
micro-batches and run ``test_best`` on the test split; the port's hoist
stays off and its optimizer made 2 updates. The two CLIs initialise their
weights apart, so their numbers are held by ``tests/test_torch_multisteps.py``,
not here (``tests/test_torch_dataset_cli_resampled.py`` runs the same
with one train wav at 44.1 kHz). ``cli.whisper_ft --do_train --do_eval``
trains on the tree; ``prefetch_batches: 2`` uploads ahead through
``prefetch_to_device``. Without ``--device cpu`` both need the card.
"""

import json

import pytest
import torch

import avsl_tpu.train.runner as jax_runner_module
import avsl_tpu_torch.train.runner as port_runner_module
from avsl_tpu.cli import finetune as jax_finetune
from avsl_tpu_torch.cli import finetune, whisper_ft
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)
from torch_dataset_fixtures import write_tree


def _recording_logger(made):
    class Recording:
        """MetricLogger that keeps ``(step, metric names)`` in memory."""

        def __init__(self, log_dir):
            self.lines = []
            made.append(self)

        def log(self, step, metrics):
            self.lines.append((int(step), sorted(metrics)))

    return Recording


def _steps_logging(logger, key):
    return [step for step, keys in logger.lines if key in keys]


def _yaml(tmp_path, root):
    keys = dict(model_name="test", precision=32, add_gated_x_attn=1, use_av_hubert_encoder=True,
                train_data_path=str(root / "train"), val_data_path=str(root / "val"),
                test_data_path=str(root / "test"), audio_max_length=16000, batch_size=2,
                eval_batch_size=2, num_train_steps=2, warmup_steps=1,
                gradient_accumulation_steps=2, validate_every_n_batches=2,
                num_sanity_val_steps=0, freeze_video_batch_norm_stats=True,
                spec_augment="ls-basic", train_id="dataset_test",
                log_output_dir=str(tmp_path / "logs"), check_output_dir=str(tmp_path / "ckpt"))
    path = tmp_path / "cfg.yaml"
    path.write_text("".join(f"{k}: {str(v).lower() if isinstance(v, bool) else v}\n"
                            for k, v in keys.items()))
    return str(path)


def finetune_like_jax(tmp_path, monkeypatch, rate):
    """Both CLIs on a fresh tree whose first train wav is at ``rate``."""
    root = tmp_path / "ami"
    write_tree(root, {"train": 8, "val": 4, "test": 4}, seed=2,
               rates={"train": [rate] + [16000] * 7})
    cfg = _yaml(tmp_path, root)
    loggers = {"port": [], "jax": []}
    monkeypatch.setattr(port_runner_module, "MetricLogger", _recording_logger(loggers["port"]))
    monkeypatch.setattr(jax_runner_module, "MetricLogger", _recording_logger(loggers["jax"]))
    made = []
    base = port_runner_module.TrainerRunner

    class Runner(base):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    monkeypatch.setattr(port_runner_module, "TrainerRunner", Runner)
    saves = []
    save = port_runner_module.save_checkpoint
    monkeypatch.setattr(port_runner_module, "save_checkpoint",
                        lambda d, state, step, **kw: (saves.append(step), save(d, state, step, **kw))[1])
    monkeypatch.chdir(tmp_path)

    got = finetune.main([cfg, "--device", "cpu"])
    want = jax_finetune.main([cfg])
    assert got["final_step"] == want["final_step"] == 4  # 2 steps x accumulation 2
    assert got["hoisted"] is False
    (runner,) = made
    opt = runner.state.optimizer
    assert runner.accum == 1 and opt.count == 2 and opt.mini_step == 0
    # one save a validation; the end of fit does not write step 4 again
    assert saves == [2, 4]
    (port_log,), (jax_log,) = loggers["port"], loggers["jax"]
    assert _steps_logging(port_log, "val/wer_av") == _steps_logging(jax_log, "val/wer_av") == [2, 4]
    assert len(_steps_logging(port_log, "test/wer_av")) == 1
    assert len(_steps_logging(jax_log, "test/wer_av")) == 1
    assert sorted(got["test"]) == sorted(want["test"])
    assert 0.0 <= got["test"]["test/wer_av"]


def test_torch_finetune_trains_on_a_dataset_like_jax(tmp_path, monkeypatch):
    finetune_like_jax(tmp_path, monkeypatch, 16000)


def test_torch_finetune_prefetches_on_a_dataset(tmp_path, monkeypatch):
    """``prefetch_batches: 2`` wraps the train batches in
    ``prefetch_to_device`` on the run's device."""
    import avsl_tpu_torch.data.prefetch as prefetch

    root = tmp_path / "ami"
    write_tree(root, {"train": 8, "val": 4}, seed=4)
    cfg = _yaml(tmp_path, root)
    with open(cfg, "a") as f:
        f.write("prefetch_batches: 2\n")
    wrapped = []
    plain = prefetch.prefetch_to_device

    def recording(it, device, size=2, mesh=None):
        wrapped.append((str(device), size))
        return plain(it, device, size=size, mesh=mesh)

    monkeypatch.setattr(prefetch, "prefetch_to_device", recording)
    monkeypatch.chdir(tmp_path)
    result = finetune.main([cfg, "--device", "cpu"])
    assert result["final_step"] == 4 and "test" not in result
    assert wrapped and set(wrapped) == {("cpu", 2)}


def test_torch_whisper_ft_trains_on_a_dataset(tmp_path):
    root = tmp_path / "ami"
    write_tree(root, {"train": 8, "val": 4}, seed=3, rates={"train": [44100] + [16000] * 7})
    out = tmp_path / "wft"
    results = whisper_ft.main(["--config", _yaml(tmp_path, root), "--device", "cpu",
                               "--do_train", "--do_eval", "--num_beams", "2",
                               "--max_eval_tokens", "16", "--output_dir", str(out)])
    # batches of batch 2 x accumulation 2 = 4 items: 2 an epoch, 2 steps
    assert results["train"]["final_step"] == 2 and results["train"]["best_step"] == 2
    assert results["eval"]["n"] == 4
    assert json.loads((out / "results.json").read_text()) == results


def test_torch_dataset_clis_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        finetune.main([_yaml(tmp_path, tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        whisper_ft.main(["--config", _yaml(tmp_path, tmp_path), "--do_train"])
