"""Lip video in the training data, checkpoint triage and restore, and the
hoist gate, against the JAX package (CPU).

* ``AmiVideoDataset(load_video=True)`` and ``WhisperVideoCollator`` on
  rows with mp4 lip clips written by cv2 (one longer than its audio, so
  trimmed), and one without a clip (one zero frame): every item and the
  collated batch, with and without a pinned ``video_pad_len``, equal to
  JAX's (mel atol 5e-5, the log-mel parity; video and masks exact, both
  decode with cv2);
* ``trim_video_to_audio`` exact;
* ``partial_load``'s triage and ``restore_params_only`` against a
  trained Flamingo state, BatchNorm statistics included, and
  ``load_torch_checkpoint_into`` (``pt_ckpt``) with its embedding guard;
* the hoist gate against the JAX CLI's own decision (its ``main`` run up
  to the runner, whose ``precompute_fn`` is read) on four configs.
"""

import numpy as np
import pytest
import torch

from avsl_tpu.data.runtime import AmiVideoDataset as JaxDataset
from avsl_tpu.data.runtime import WhisperVideoCollator as JaxCollator
from avsl_tpu.data.tokenizer import get_tokenizer as jax_get_tokenizer
from avsl_tpu.data.video_io import trim_video_to_audio as jax_trim
from avsl_tpu_torch.cli.finetune import hoist_enabled, make_synthetic_dataset
from avsl_tpu_torch.core.config import FlamingoTrainConfig
from avsl_tpu_torch.data.runtime import AmiVideoDataset, WhisperVideoCollator
from avsl_tpu_torch.data.tokenizer import get_tokenizer
from avsl_tpu_torch.data.video_io import trim_video_to_audio
from avsl_tpu_torch.models import build_whisper_flamingo
from avsl_tpu_torch.models.convert import load_torch_checkpoint_into
from avsl_tpu_torch.train import TrainState, select_optimizer
from avsl_tpu_torch.train.checkpoints import (
    partial_load,
    restore_checkpoint,
    restore_params_only,
    save_checkpoint,
)
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)
from test_torch_pipeline import _write_lip_mp4


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lips")
    rows = make_synthetic_dataset(4, seconds=0.8)
    rows[0]["lip_video"] = _write_lip_mp4(tmp / "a-lip.mp4", 12, seed=1)
    rows[1]["lip_video"] = {"path": _write_lip_mp4(tmp / "b-lip.mp4", 40, seed=2, size=80)}
    rows[2]["lip_video"] = str(tmp / "missing-lip.mp4")
    return rows


def test_torch_av_dataset_and_collator_match_jax(rows):
    jtok, ptok = jax_get_tokenizer(None, "en"), get_tokenizer(None, "en")
    jds = JaxDataset(rows, jtok, audio_max_length=16000, load_video=True, train=True)
    pds = AmiVideoDataset(rows, ptok, audio_max_length=16000, load_video=True, train=True)
    lengths = []
    for i in range(len(rows)):
        want, got = jds[i], pds[i]
        assert sorted(got) == sorted(want)
        np.testing.assert_allclose(got["input_ids"], want["input_ids"], atol=5e-5, rtol=1e-5)
        for key in ("dec_input_ids", "labels", "video"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got["video"].dtype == np.float32 and got["video"].shape[1:] == (88, 88, 1)
        lengths.append(len(got["video"]))
    # 12 frames; 40 trimmed to the padded 1 s of audio at 25 fps; no clip: one zero frame
    assert lengths == [12, 25, 1, 1] and not pds[3]["video"].any()
    for pad in (None, 30):
        want = JaxCollator(eot_id=jtok.eot, video_pad_len=pad)([jds[i] for i in range(4)])
        got = WhisperVideoCollator(eot_id=ptok.eot, video_pad_len=pad)([pds[i] for i in range(4)])
        assert sorted(got) == sorted(want)
        for key in ("dec_input_ids", "labels", "audio_frames", "video", "video_mask"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got["video"].shape == (4, pad or 25, 88, 88, 1)
        assert got["video_mask"].sum(1).tolist() == [12, 25, 1, 1]


@pytest.mark.parametrize("n,samples", [(30, 16000), (10, 16000), (30, 12345), (0, 800)])
def test_torch_trim_video_to_audio_matches_jax(n, samples):
    video = np.arange(n * 4, dtype=np.float32).reshape(n, 2, 2, 1)
    np.testing.assert_array_equal(trim_video_to_audio(video, samples),
                                  jax_trim(video, samples))


def _tiny_flamingo(seed):
    return build_whisper_flamingo("test", add_gated_x_attn=1, dtype="float32",
                                  param_dtype="float32", device="cpu", seed=seed)


def test_torch_partial_load_and_restore_params_only(tmp_path):
    """A trained state's weights and BatchNorm statistics survive
    save_checkpoint / restore_params_only; partial_load reports what it
    took, what it lacked and what did not fit."""
    model, _ = _tiny_flamingo(0)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if "running_" in name:
                buf.add_(torch.rand(buf.shape, generator=torch.Generator().manual_seed(1)))
    opt, _ = select_optimizer(model, FlamingoTrainConfig(), 10)
    save_checkpoint(str(tmp_path), TrainState.create(model, opt), 7)
    saved = restore_params_only(str(tmp_path))
    assert restore_params_only(str(tmp_path / "none")) is None
    assert sorted(saved) == sorted(model.state_dict())
    fresh, _ = _tiny_flamingo(1)
    loaded = dict(saved)
    loaded["decoder.ln.weight"] = torch.zeros(3)  # a shape mismatch
    loaded["extra.weight"] = torch.zeros(2)  # unexpected
    del loaded["video_projection.bias"]  # missing
    _, report = partial_load(fresh, loaded)
    assert report["shape_mismatch"] == ["decoder.ln.weight"]
    assert report["unexpected"] == ["extra.weight"] and report["missing"] == ["video_projection.bias"]
    assert len(report["loaded"]) == len(saved) - 2
    for key, value in fresh.state_dict().items():
        if key in report["loaded"]:
            assert torch.equal(value, saved[key]), key
    assert any("running_var" in k for k in report["loaded"])
    with pytest.raises(ValueError, match="Strict load failed"):
        partial_load(fresh, loaded, strict=True)
    # the full state restores into a train state of the same model
    other, _ = _tiny_flamingo(2)
    restore_checkpoint(str(tmp_path), TrainState.create(other, select_optimizer(
        other, FlamingoTrainConfig(), 10)[0]))
    for key, value in other.state_dict().items():
        assert torch.equal(value, model.state_dict()[key]), key


def test_torch_pt_ckpt_loads_through_partial_load(tmp_path):
    """A PyTorch Whisper checkpoint (``model.``-prefixed, nested under
    "state_dict") loads its Whisper tensors and leaves the tower and the
    gated sublayers; a vocab mismatch on the embedding raises."""
    source, _ = build_whisper_flamingo("test", add_gated_x_attn=0, dtype="float32",
                                       device="cpu", seed=3)
    path = tmp_path / "whisper.pt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in source.state_dict().items()}}, path)
    model, _ = _tiny_flamingo(0)
    report = load_torch_checkpoint_into(model, str(path))
    assert not report["unexpected"] and not report["shape_mismatch"]
    assert all(k.startswith(("video_model.", "video_projection.")) or ".x_" in k
               for k in report["missing"])
    assert torch.equal(model.decoder.token_embedding.weight,
                       source.decoder.token_embedding.weight)
    small, _ = build_whisper_flamingo("test", add_gated_x_attn=0, vocab_size=200,
                                      dtype="float32", device="cpu")
    torch.save(small.state_dict(), path)
    with pytest.raises(ValueError, match="token_embedding"):
        load_torch_checkpoint_into(model, str(path))


class _Stop(Exception):
    pass


def _jax_hoist_decision(monkeypatch, tmp_path, yaml_text):
    """Run the JAX CLI's main under --smoke up to its runner and return
    whether it passed a precompute_fn."""
    import avsl_tpu.train.runner as jax_runner
    from avsl_tpu.cli import finetune as jax_finetune

    seen = {}

    def stop(*args, precompute_fn=None, **kw):
        seen["hoist"] = precompute_fn is not None
        raise _Stop

    monkeypatch.setattr(jax_runner, "TrainerRunner", stop)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml_text)
    with pytest.raises(_Stop):
        jax_finetune.main([str(cfg_path), "--smoke"])
    return seen["hoist"]


@pytest.mark.parametrize("yaml_text,want", [
    ("freeze_video_batch_norm_stats: false\n", False),
    ("freeze_video_batch_norm_stats: true\ngradient_accumulation_steps: 2\n", True),
    ("freeze_video_batch_norm_stats: true\ngradient_accumulation_steps: 1\n", False),
    ("freeze_video_batch_norm_stats: true\nadd_gated_x_attn: 0\n"
     "video_projection_train_only: true\n", True),
], ids=["bn_trains", "bn_frozen_accum2", "bn_frozen_accum1", "audio_only_all_frozen"])
def test_torch_hoist_gate_matches_jax(monkeypatch, tmp_path, yaml_text, want):
    assert _jax_hoist_decision(monkeypatch, tmp_path, yaml_text) is want
    path = tmp_path / "cfg.yaml"
    cfg = FlamingoTrainConfig.from_yaml(str(path))
    accum = min(int(cfg.gradient_accumulation_steps), 2)  # as --smoke caps it
    model, _ = build_whisper_flamingo("test", add_gated_x_attn=cfg.add_gated_x_attn,
                                      use_av_hubert_encoder=cfg.use_av_hubert_encoder,
                                      device="cpu")
    _, labels = select_optimizer(model, cfg, 6)
    assert hoist_enabled(labels, cfg, 0, accum) is want
    assert hoist_enabled(labels, cfg, 4, accum) is False  # LoRA never hoists
