"""Transcriber construction for the port's serving CLI: tokenizer, model
build on the device, checkpoint restore, and the StreamingTranscriber.

Port of the parts of ``avsl_tpu/cli/_serving_common.py`` that
``cli/transcribe.py`` needs. Without ``--ckpt_dir`` the model has seeded
random weights; with it, the latest checkpoint a trainer wrote there
(an empty directory exits rather than serve random weights).
"""

from __future__ import annotations

from typing import Optional


def build_target_model(cfg, tokenizer, smoke: bool, ckpt_dir: Optional[str],
                       device: str = "cuda", seed: int = 0):
    """Build the config's Whisper model on ``device`` (``<laugh>`` added to
    the tokenizer, vocab sized to match) and, with ``ckpt_dir``, restore
    its latest checkpoint through the config's optimizer, as
    ``avsl_tpu/cli/_serving_common.py:63-76`` does (the weights, BatchNorm
    statistics included, cast to the serving dtype). Returns ``(model,
    w_cfg)``, the model in eval mode."""
    from avsl_tpu_torch.models.factory import build_whisper_flamingo
    from avsl_tpu_torch.train.checkpoints import latest_step, restore_checkpoint
    from avsl_tpu_torch.train.loop import TrainState
    from avsl_tpu_torch.train.optim import select_optimizer

    vocab = tokenizer.add_tokens(["<laugh>"])
    model, w_cfg = build_whisper_flamingo(
        cfg.model_name, vocab_size=vocab,
        add_gated_x_attn=cfg.add_gated_x_attn,
        use_av_hubert_encoder=cfg.use_av_hubert_encoder,
        dtype="float32" if smoke else "bfloat16",
        device=device, seed=seed,
    )
    if ckpt_dir:
        if latest_step(ckpt_dir) is None:
            # never serve random weights from a mistyped or empty directory
            raise SystemExit(f"no checkpoint under {ckpt_dir!r}")
        tx, _ = select_optimizer(model, cfg, 1)
        restore_checkpoint(ckpt_dir, TrainState.create(model, tx))
    return model.eval(), w_cfg


def serving_video_frames(audio_max_length: int) -> int:
    """Video frames a serving batch holds: the audio window at 25 fps,
    at most 250 (10 s)."""
    return min(int(round(audio_max_length / 16000 * 25)), 250)


def build_transcriber(args, cfg):
    from avsl_tpu_torch.data.tokenizer import get_tokenizer
    from avsl_tpu_torch.infer.pipeline import StreamingTranscriber

    smoke = bool(getattr(args, "smoke", False))
    tokenizer = get_tokenizer(getattr(cfg, "download_root", None), cfg.lang)
    model, _ = build_target_model(
        cfg, tokenizer, smoke, args.ckpt_dir, device=args.device
    )
    return StreamingTranscriber(
        model, tokenizer,
        audio_max_length=int(cfg.audio_max_length),
        video_frames=serving_video_frames(int(cfg.audio_max_length)),
        batch_size=args.batch_size,
        max_new_tokens=args.max_new_tokens,
        beam_size=args.beam,
        lang=cfg.lang,
    )


def csv_cell(row: dict, *keys) -> Optional[str]:
    """First non-empty string cell among ``keys`` (pandas' NaN counts as
    empty)."""
    for k in keys:
        v = row.get(k)
        if v is None or (isinstance(v, float) and v != v):
            continue
        v = str(v).strip()
        if v and v.lower() != "nan":
            return v
    return None
