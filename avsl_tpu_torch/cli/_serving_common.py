"""Transcriber construction for the port's serving CLI: tokenizer, model
build on the device, checkpoint restore, and the StreamingTranscriber.

Port of ``avsl_tpu/cli/_serving_common.py`` for ``cli/transcribe.py`` and
``cli/serve.py``. Without ``--ckpt_dir`` the model has seeded random
weights; with it, the latest checkpoint a trainer wrote there (an empty
directory exits rather than serve random weights). The serving options of
later work raise before any model is built, naming their item.
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


def refuse_unported(args) -> None:
    """Raise for the serving flags whose modules are not ported yet, each
    mapped onto its transcriber option in ``infer.pipeline.UNPORTED``,
    before any model is built."""
    from avsl_tpu_torch.infer.pipeline import not_ported

    asked = [
        ("quantize", "--quantize", getattr(args, "quantize", None) is not None),
        ("kv_int8", "--kv_int8", bool(getattr(args, "kv_int8", False))),
        ("draft_model", "--draft_model/--draft_ckpt/--spec_k",
         bool(getattr(args, "draft_model", None) or getattr(args, "draft_ckpt", None))
         or getattr(args, "spec_k", None) is not None),
        ("mesh", "--model_parallel/--data_parallel",
         (getattr(args, "model_parallel", 1) or 1) > 1
         or (getattr(args, "data_parallel", 1) or 1) > 1),
    ]
    for option, flags, bad in asked:
        if bad:
            raise not_ported(option, flags)


def parse_temperatures(text: str):
    """``"0.2,0.4"`` -> (0.2, 0.4); empty -> ()."""
    return tuple(float(t) for t in (text or "").split(",") if t.strip())


def build_transcriber(args, cfg):
    from avsl_tpu_torch.data.tokenizer import get_tokenizer
    from avsl_tpu_torch.infer.pipeline import StreamingTranscriber

    refuse_unported(args)
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
        temperature_fallback=parse_temperatures(getattr(args, "temperature_fallback", "")),
        logprob_threshold=getattr(args, "logprob_threshold", -1.0),
        word_timestamps=bool(getattr(args, "word_timestamps", False)),
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
