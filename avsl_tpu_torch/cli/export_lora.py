"""LoRA merged-export CLI of the port: adapters + base -> a full checkpoint.

Usage: ``python -m avsl_tpu_torch.cli.export_lora --config train.yaml
--adapter_ckpt runs/lora_ckpt [--base_ckpt runs/base_ckpt] --output
runs/merged [--smoke] [--device cuda|cpu]``

Port of ``avsl_tpu/cli/export_lora.py``. A LoRA fine-tune
(``cli/finetune.py`` with ``lora_rank > 0``) checkpoints the adapters and
the BatchNorm statistics only; this merges ``W + (alpha/rank) * A @ B``
once (``models/lora.py::merge_lora``, what training's forward computes)
and writes a full checkpoint at the adapters' step that ``cli.transcribe``
/ ``cli.serve --ckpt_dir`` load like any other (the weights and BatchNorm
statistics, no optimizer state: JAX's carries the base's fresh one). The
base is the config's
seeded model, or ``--base_ckpt``'s latest step; a ``--base_ckpt`` with no
checkpoint exits rather than merge onto random weights. The BatchNorm
statistics are the adapter checkpoint's, the ones the LoRA run evaluated
with (JAX's keeps the base's; ROADMAP.md §3). Runs on ``cuda`` unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def main(argv: Optional[List[str]] = None):
    import torch

    from avsl_tpu_torch.cli.finetune import build_model, make_lora
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.core.device import resolve_device
    from avsl_tpu_torch.data.tokenizer import get_tokenizer
    from avsl_tpu_torch.models import lora as lora_mod
    from avsl_tpu_torch.train.checkpoints import (
        latest_step,
        restore_params_only,
        save_checkpoint,
    )
    from avsl_tpu_torch.train.loop import TrainState

    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None,
                   help="the LoRA training YAML (lora_rank/alpha/targets)")
    p.add_argument("--adapter_ckpt", required=True)
    p.add_argument("--base_ckpt", default=None,
                   help="checkpoint dir of the frozen base (default: the config's init)")
    p.add_argument("--output", required=True)
    p.add_argument("--smoke", action="store_true", help="tiny preset (tests)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = FlamingoTrainConfig.from_yaml(args.config) if args.config else FlamingoTrainConfig()
    if args.smoke:
        cfg.model_name = "test"
        cfg.audio_max_length = 16000
    rank = int(getattr(cfg, "lora_rank", 0) or 0)
    if rank <= 0:
        raise SystemExit("config has lora_rank=0 — nothing to export")

    tokenizer = get_tokenizer(getattr(cfg, "download_root", None), cfg.lang)
    state = TrainState.create(build_model(cfg, tokenizer, device, smoke=args.smoke)[0], None)
    if args.base_ckpt:
        base = restore_params_only(args.base_ckpt)
        if base is None:
            # never merge onto random base weights: the result would look
            # servable and be garbage
            raise SystemExit(f"no base checkpoint under {args.base_ckpt!r}")
        state.model.load_state_dict(base)
    step = latest_step(args.adapter_ckpt)
    if step is None:
        raise SystemExit(f"no adapter checkpoint under {args.adapter_ckpt!r}")
    lora = make_lora(cfg, state.model)
    lora.load_state_dict(restore_params_only(args.adapter_ckpt, step))
    merged = lora.merged_weights()
    named = dict(state.model.named_parameters())
    with torch.no_grad():
        for key, value in merged.items():
            named[key].copy_(value)
    state.step = step
    save_checkpoint(args.output, state, step)
    summary = lora_mod.lora_summary(state.model, lora.adapters())
    print(f"merged rank={rank} alpha={lora.alpha} adapters={summary['n_adapters']} "
          f"({100 * summary['trainable_fraction']:.3f}% of base) -> {args.output} @ step {step}")
    return state


if __name__ == "__main__":
    main()
