"""Whisper-Flamingo fine-tuning entry point of the port.

Usage: ``python -m avsl_tpu_torch.cli.finetune [config.yaml] [--smoke]
[--device cuda|cpu]``

Port of ``avsl_tpu/cli/finetune.py``: the YAML keys of the reference's
training config (``configs/ami_whisper_flamingo_large.yaml``), ``<laugh>``
added and the vocab sized to the tokenizer, Whisper large-v2 with the
AV-HuBERT video tower (``add_gated_x_attn: 1``) trained under the regime
``select_optimizer`` picks (Flamingo: the gated ``x_attn``/``x_mlp``
sublayers, their gates and ``video_projection``; everything else frozen),
``flamingo_loss_fn`` with the YAML's SpecAugment, AV-mode mixing and
``freeze_video_batch_norm_stats``, the frozen-tower hoist under the JAX
CLI's own gate (:func:`hoist_enabled`), labels pinned to
``text_max_length``, teacher-forced WER validation, best checkpoint and
``pt_ckpt`` triage through ``partial_load``. Weights are fp32 and the
compute bf16 (fp32 with ``--smoke``); the YAML's
``enable_gradient_checkpointing`` is not taken (no activation
checkpointing in the port yet), which changes memory, not values.

``--smoke`` trains the tiny test model on a synthetic dataset with the
JAX CLI's settings (6 steps, batch 4 × accumulation min(YAML, 2),
validation every 3 steps). Without it the datasets must be loaded, which
waits for ``load_datasets`` and length bucketing (ROADMAP.md queue 1,
item 13) and raises, as do LoRA, a mesh and double-buffered prefetch
(items 12 and 13). Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from avsl_tpu_torch.train.optim import TRAIN


def make_synthetic_dataset(n: int = 8, seconds: float = 1.0) -> List[Dict[str, Any]]:
    """Miniature in-memory dataset for --smoke (no AMI data needed)."""
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        sr = 16000
        audio = (0.1 * rng.standard_normal(int(seconds * sr))).astype(np.float32)
        rows.append(
            {
                "audio": {"array": audio, "sampling_rate": sr},
                "transcript": f"synthetic utterance number {i}",
                "duration": seconds,
                "lip_video": None,
            }
        )
    return rows


def hoist_enabled(labels: Dict[str, str], cfg, lora_rank: int = 0, accum: int = 1) -> bool:
    """Whether the frozen towers are hoisted out of the accumulation loop,
    decided as the JAX CLI decides it (``finetune.py:279-302``): no LoRA,
    accumulation above 1, every parameter of the Whisper encoder and the
    video model labelled frozen (and at least one of them present),
    ``freeze_video_batch_norm_stats`` and ``hoist_frozen_towers`` (default
    on). The tower's LayerDrop is not consulted, as in JAX: above 0 it
    draws once a step for all the micro-steps."""
    if lora_rank != 0 or accum <= 1:
        return False
    tower = [v for k, v in labels.items() if k.split(".")[0] in ("encoder", "video_model")]
    towers_frozen = bool(tower) and all(v != TRAIN for v in tower)
    bn_frozen = bool(getattr(cfg, "freeze_video_batch_norm_stats", False))
    return towers_frozen and bn_frozen and bool(getattr(cfg, "hoist_frozen_towers", True))


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md queue 1, {item})")


def build_model(cfg, tokenizer, device, smoke: bool = False,
                vocab_size: Optional[int] = None, seed: int = 0):
    """The config's Whisper(-Flamingo) on ``device``, fp32 weights, with
    ``<laugh>`` added to ``tokenizer`` and the vocab sized to it (or to
    ``vocab_size`` when that is larger, e.g. a preset's full vocab over
    the offline byte tokenizer). Compute is fp32 under ``--smoke`` or a
    precision other than 16/bf16, else bf16. Returns ``(model, w_cfg)``."""
    from avsl_tpu_torch.models.factory import build_whisper_flamingo

    vocab = tokenizer.add_tokens(["<laugh>"])
    if vocab_size is not None:
        if vocab_size < vocab:
            raise ValueError(f"vocab_size {vocab_size} < the tokenizer's {vocab}")
        vocab = vocab_size
    bf16 = cfg.precision in (16, "16", "bf16")
    return build_whisper_flamingo(
        cfg.model_name, vocab_size=vocab, add_gated_x_attn=cfg.add_gated_x_attn,
        use_av_hubert_encoder=cfg.use_av_hubert_encoder, dropout_rate=cfg.dropout_rate,
        dtype="float32" if smoke or not bf16 else "bfloat16", param_dtype="float32",
        device=device, seed=seed,
    )


def make_dataset(rows, tokenizer, cfg, w_cfg, train: bool):
    """``AmiVideoDataset`` over ``rows``, with lip video for a gated model."""
    from avsl_tpu_torch.data.runtime import AmiVideoDataset

    return AmiVideoDataset(rows, tokenizer, audio_max_length=int(cfg.audio_max_length),
                           n_mels=w_cfg.n_mels, lang=cfg.lang,
                           load_video=bool(cfg.add_gated_x_attn), train=train)


def make_collator(tokenizer, cfg, w_cfg):
    """The collator with the labels pinned to ``min(text_max_length,
    n_text_ctx)``, as the JAX CLI pins them."""
    from avsl_tpu_torch.data.runtime import WhisperVideoCollator

    label_len = min(int(getattr(cfg, "text_max_length", 350)), w_cfg.n_text_ctx)
    return WhisperVideoCollator(eot_id=tokenizer.eot, label_pad_len=label_len,
                                max_label_len=label_len)


def make_runner(cfg, model, tokenizer, log_dir: str, ckpt_dir: str, seed: int = 0):
    """``TrainerRunner`` over the regime ``select_optimizer`` picks,
    ``flamingo_loss_fn`` with the config's SpecAugment, AV-mode mixing and
    BatchNorm freeze, and the frozen-tower hoist when
    :func:`hoist_enabled`; the runner's ``hoisted`` says which."""
    from avsl_tpu_torch.train.loop import TrainState, batch_to_device
    from avsl_tpu_torch.train.objectives import flamingo_loss_fn, flamingo_tower_precompute
    from avsl_tpu_torch.train.optim import select_optimizer
    from avsl_tpu_torch.train.runner import TrainerRunner

    tx, labels = select_optimizer(model, cfg, int(cfg.num_train_steps))
    accum = max(int(cfg.gradient_accumulation_steps), 1)
    mixing = dict(spec_augment=getattr(cfg, "spec_augment", None),
                  prob_av=float(cfg.prob_use_av), prob_a=float(cfg.prob_use_a))
    loss_fn = flamingo_loss_fn(
        model, train=True,
        freeze_video_bn_stats=bool(getattr(cfg, "freeze_video_batch_norm_stats", False)),
        **mixing)
    precompute = None
    if hoist_enabled(labels, cfg, int(getattr(cfg, "lora_rank", 0) or 0), accum):
        precompute = flamingo_tower_precompute(model, train=True, freeze_video_bn_stats=True,
                                               **mixing)

    @torch.no_grad()
    def eval_logits(state, batch):
        state.model.eval()
        b = batch_to_device(batch, state.model.device)
        return state.model(b["input_ids"], b["dec_input_ids"], video=b.get("video"))

    runner = TrainerRunner(
        loss_fn, eval_logits, tx, TrainState.create(model, tx, seed=seed), tokenizer, cfg,
        log_dir=log_dir, ckpt_dir=ckpt_dir, grad_accum_steps=accum, param_labels=labels,
        precompute_fn=precompute,
    )
    runner.hoisted = precompute is not None
    return runner


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    from avsl_tpu_torch.cli.whisper_ft import batches
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.core.device import resolve_device
    from avsl_tpu_torch.data.tokenizer import get_tokenizer
    from avsl_tpu_torch.models.convert import load_torch_checkpoint_into

    p = argparse.ArgumentParser()
    p.add_argument("config", nargs="?", default=None)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg = FlamingoTrainConfig.from_yaml(args.config) if args.config else FlamingoTrainConfig()
    if not args.smoke:
        raise _not_ported("load_datasets and length bucketing (real datasets; run with --smoke)",
                          "item 13")
    cfg.model_name = "test"
    cfg.num_train_steps = 6
    cfg.validate_every_n_batches = 3
    # a YAML's accumulation (capped at 2) goes through, so the accumulation
    # and the hoist can be driven under --smoke
    cfg.gradient_accumulation_steps = min(
        int(getattr(cfg, "gradient_accumulation_steps", 1) or 1), 2)
    cfg.batch_size = 4
    cfg.audio_max_length = 16000
    cfg.warmup_steps = 1
    if int(getattr(cfg, "lora_rank", 0) or 0) > 0:
        raise _not_ported("lora_rank > 0 (models/lora.py)", "item 12")
    if int(getattr(cfg, "model_parallel", 1) or 1) > 1 or int(cfg.num_devices or 1) > 1:
        raise _not_ported("a device mesh (model_parallel or num_devices > 1)", "item 12")
    if int(getattr(cfg, "prefetch_batches", 0) or 0) > 0:
        raise _not_ported("prefetch_batches > 0 (data/prefetch.py)", "item 13")

    tokenizer = get_tokenizer(getattr(cfg, "download_root", None), cfg.lang)
    model, w_cfg = build_model(cfg, tokenizer, device, smoke=True)
    train_ds = make_dataset(make_synthetic_dataset(8), tokenizer, cfg, w_cfg, train=True)
    val_ds = make_dataset(make_synthetic_dataset(4), tokenizer, cfg, w_cfg, train=False)
    collator = make_collator(tokenizer, cfg, w_cfg)
    if getattr(cfg, "pt_ckpt", "") and os.path.exists(cfg.pt_ckpt):
        report = load_torch_checkpoint_into(model, cfg.pt_ckpt)
        print(f"pt_ckpt: loaded {len(report['loaded'])} tensors, "
              f"missing {len(report['missing'])}, unexpected {len(report['unexpected'])}")
    runner = make_runner(cfg, model, tokenizer,
                         log_dir=os.path.join(cfg.log_output_dir, cfg.train_id),
                         ckpt_dir=os.path.join(cfg.check_output_dir, cfg.train_id))
    result = runner.fit(
        train_batches=lambda epoch: batches(train_ds, collator, int(cfg.batch_size) * runner.accum,
                                            True, epoch),
        val_batches=lambda: batches(val_ds, collator, int(cfg.eval_batch_size), False),
        num_steps=int(cfg.num_train_steps),
        validate_every=int(cfg.validate_every_n_batches),
        sanity_val_steps=int(getattr(cfg, "num_sanity_val_steps", 0)),
    )
    result["hoisted"] = runner.hoisted
    print(f"done: step={result['final_step']} best_wer={result['best_wer']:.4f} "
          f"(step {result['best_step']})")
    return result


if __name__ == "__main__":
    main()
