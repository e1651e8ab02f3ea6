"""Transcriber construction for the port's serving CLI: tokenizer, model
build on the device, and the StreamingTranscriber.

Port of the parts of ``avsl_tpu/cli/_serving_common.py`` that
``cli/transcribe.py`` needs. Checkpoint restore is not ported yet, so the
model always has seeded random weights.
"""

from __future__ import annotations

from typing import Optional


def build_target_model(cfg, tokenizer, smoke: bool, ckpt_dir: Optional[str],
                       device: str = "cuda", seed: int = 0):
    """Build the config's Whisper model on ``device`` (``<laugh>`` added to
    the tokenizer, vocab sized to match). Returns ``(model, w_cfg)``."""
    from avsl_tpu_torch.models.factory import build_whisper_flamingo

    if ckpt_dir:
        raise NotImplementedError(
            "--ckpt_dir: restoring trained weights into the transcriber is not "
            "ported yet (ROADMAP.md queue 1, item 8: restore_params_only)"
        )
    vocab = tokenizer.add_tokens(["<laugh>"])
    return build_whisper_flamingo(
        cfg.model_name, vocab_size=vocab,
        add_gated_x_attn=cfg.add_gated_x_attn,
        use_av_hubert_encoder=cfg.use_av_hubert_encoder,
        dtype="float32" if smoke else "bfloat16",
        device=device, seed=seed,
    )


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
