"""Transcriber construction for the port's serving CLIs: tokenizer, model
build on the device, checkpoint restore, the speculative draft, and the
StreamingTranscriber.

Port of ``avsl_tpu/cli/_serving_common.py`` for ``cli/transcribe.py``,
``cli/serve.py`` and ``cli/export_program.py``. Without ``--ckpt_dir`` the
model has seeded random weights; with it, the latest checkpoint a trainer
wrote there (an empty directory exits rather than serve random weights),
whose fp32 weights ``--quantize int8`` quantizes. ``--draft_model <preset>``
builds that Whisper preset audio-only as the speculative draft, with
``--draft_ckpt``'s weights (a random draft is refused outside
``--smoke``). ``--model_parallel``/``--data_parallel`` above 1 serve on a
(data, model) mesh: one process a rank under ``python -m
torch.distributed.run``, whose world size must be their product; each rank
builds the same seeded (or restored) model on its card, and the
transcriber shards it (``infer/pipeline.py``).
"""

from __future__ import annotations

from typing import Optional


def build_target_model(cfg, tokenizer, smoke: bool, ckpt_dir: Optional[str],
                       device: str = "cuda", seed: int = 0):
    """``(model, w_cfg)`` of :func:`build_target_with_weights`."""
    return build_target_with_weights(cfg, tokenizer, smoke, ckpt_dir, device, seed)[:2]


def build_target_with_weights(cfg, tokenizer, smoke: bool, ckpt_dir: Optional[str],
                              device: str = "cuda", seed: int = 0):
    """Build the config's Whisper model on ``device`` (``<laugh>`` added to
    the tokenizer, vocab sized to match) and, with ``ckpt_dir``, restore
    its latest checkpoint as ``avsl_tpu/cli/_serving_common.py:63-76``
    does (:func:`restore_weights`: the weights, BatchNorm statistics
    included, cast to the serving dtype; the port's checkpoint holds the
    state dict apart from the optimizer, so none is built). Returns ``(model,
    w_cfg, weights)``: the model in eval mode, and the checkpoint's fp32
    state dict (None without ``ckpt_dir``), which ``--quantize``
    quantizes."""
    from avsl_tpu_torch.models.factory import build_whisper_flamingo

    vocab = tokenizer.add_tokens(["<laugh>"])
    model, w_cfg = build_whisper_flamingo(
        cfg.model_name, vocab_size=vocab,
        add_gated_x_attn=cfg.add_gated_x_attn,
        use_av_hubert_encoder=cfg.use_av_hubert_encoder,
        dtype="float32" if smoke else "bfloat16",
        device=device, seed=seed,
    )
    weights = restore_weights(model, ckpt_dir) if ckpt_dir else None
    return model.eval(), w_cfg, weights


def restore_weights(model, ckpt_dir: str):
    """Load the latest checkpoint under ``ckpt_dir`` into ``model`` (cast
    to its dtypes) and return the checkpoint's state dict, its fp32
    weights; an empty or mistyped directory exits rather than serve
    random weights."""
    from avsl_tpu_torch.train.checkpoints import restore_params_only

    weights = restore_params_only(ckpt_dir)
    if weights is None:
        raise SystemExit(f"no checkpoint under {ckpt_dir!r}")
    model.load_state_dict(weights)
    return weights


def serving_video_frames(audio_max_length: int) -> int:
    """Video frames a serving batch holds: the audio window at 25 fps,
    at most 250 (10 s)."""
    return min(int(round(audio_max_length / 16000 * 25)), 250)


def serving_mesh(args):
    """The (data, model) mesh of ``--data_parallel`` x ``--model_parallel``
    (``avsl_tpu/cli/_serving_common.py:95-101``): None when both are 1.
    It joins the launcher's process group first; ``args.device`` becomes
    this rank's device. Outside the launcher, or on a world of another
    size, :func:`~avsl_tpu_torch.core.mesh.make_mesh` raises."""
    mp = int(getattr(args, "model_parallel", 1) or 1)
    dp = int(getattr(args, "data_parallel", 1) or 1)
    if mp <= 1 and dp <= 1:
        return None
    from avsl_tpu_torch.core.mesh import init_distributed, make_mesh

    args.device = str(init_distributed(args.device))
    return make_mesh(dp * mp, model_parallel=mp)


def shapes_match(restored, probe) -> bool:
    """Same keys and tensor shapes (dtype-agnostic: checkpoints may hold
    another precision than the model)."""
    return (set(restored) == set(probe)
            and all(tuple(restored[k].shape) == tuple(probe[k].shape) for k in probe))


def refuse_draft_args(args, smoke: bool) -> None:
    """The draft flags' refusals, before any model is built: a draft with
    a beam, ``--spec_k`` under 1, and a random draft outside ``--smoke``
    (it decodes exactly, the verify pass rejecting it, but wastes every
    draft forward)."""
    if not getattr(args, "draft_model", None):
        return
    if args.beam > 1:
        raise SystemExit("--draft_model composes with greedy only (--beam 1)")
    spec_k = int(getattr(args, "spec_k", 4))
    if spec_k < 1:
        raise SystemExit(f"--spec_k must be >= 1, got {spec_k}")
    if not getattr(args, "draft_ckpt", None) and not smoke:
        raise SystemExit("--draft_model needs --draft_ckpt (or --smoke)")


def build_draft(args, vocab: int, smoke: bool):
    """``(draft model, its state dict or None)`` for ``--draft_model``:
    the preset built audio-only on ``args.device``, with ``--draft_ckpt``'s
    weights (checked against the preset's keys and shapes before any
    decode); ``(None, None)`` without a draft."""
    from avsl_tpu_torch.models.factory import build_whisper_flamingo
    from avsl_tpu_torch.train.checkpoints import restore_params_only

    name = getattr(args, "draft_model", None)
    if not name:
        return None, None
    draft, _ = build_whisper_flamingo(name, vocab_size=vocab, add_gated_x_attn=False,
                                      dtype="float32" if smoke else "bfloat16",
                                      device=args.device)
    ckpt = getattr(args, "draft_ckpt", None)
    if not ckpt:
        return draft, None
    restored = restore_params_only(ckpt)
    if restored is None:
        raise SystemExit(f"no checkpoint under {ckpt!r}")
    if not shapes_match(restored, draft.state_dict()):
        raise SystemExit(
            f"--draft_ckpt {ckpt!r} does not match --draft_model {name!r} (param tree/shape "
            "mismatch — was it distilled with a different --draft_model?)")
    return draft, restored


def parse_temperatures(text: str):
    """``"0.2,0.4"`` -> (0.2, 0.4); empty -> ()."""
    return tuple(float(t) for t in (text or "").split(",") if t.strip())


def build_transcriber(args, cfg):
    from avsl_tpu_torch.data.tokenizer import get_tokenizer
    from avsl_tpu_torch.infer.pipeline import StreamingTranscriber

    smoke = bool(getattr(args, "smoke", False))
    refuse_draft_args(args, smoke)
    mesh = serving_mesh(args)
    tokenizer = get_tokenizer(getattr(cfg, "download_root", None), cfg.lang)
    model, w_cfg, weights = build_target_with_weights(cfg, tokenizer, smoke, args.ckpt_dir,
                                                      device=args.device)
    draft, draft_weights = build_draft(args, w_cfg.n_vocab, smoke)
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
        quantize=getattr(args, "quantize", None),
        kv_int8=bool(getattr(args, "kv_int8", False)),
        weights=weights,
        draft_model=draft,
        draft_variables=draft_weights,
        spec_k=int(getattr(args, "spec_k", 4)),
        mesh=mesh,
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
