"""Checkpoint averaging CLI of the port ("model soup").

Usage: ``python -m avsl_tpu_torch.cli.avg_ckpt --ckpt_dir runs/ckpt
--output runs/soup [--config cfg.yaml] [--steps 400,500,600 | --last_k 3]
[--smoke] [--device cuda|cpu]``

Port of ``avsl_tpu/cli/avg_ckpt.py``: uniformly averages the parameters
and BatchNorm statistics of the selected saved steps (``train/ema.py``)
and writes the result as a new checkpoint at the newest contributing
step, with that step's optimizer state, which ``cli.transcribe`` /
``cli.serve --ckpt_dir`` load and a fine-tune can resume from. Runs on
``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def build_state(cfg, smoke: bool = False, device: str = "cuda"):
    """The train state ``cli/finetune.py`` checkpoints for ``cfg``: its
    model (``<laugh>`` added, fp32 weights) and the optimizer of the freeze
    regime ``select_optimizer`` picks, so a restore sees the same keys."""
    from avsl_tpu_torch.cli.finetune import build_model
    from avsl_tpu_torch.data.tokenizer import get_tokenizer
    from avsl_tpu_torch.train.loop import TrainState
    from avsl_tpu_torch.train.optim import select_optimizer

    tokenizer = get_tokenizer(getattr(cfg, "download_root", None), cfg.lang)
    model, _ = build_model(cfg, tokenizer, device, smoke=smoke)
    tx, _ = select_optimizer(model, cfg, 1)
    return TrainState.create(model, tx)


def main(argv: Optional[List[str]] = None):
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.core.device import resolve_device
    from avsl_tpu_torch.train.checkpoints import save_checkpoint
    from avsl_tpu_torch.train.ema import average_checkpoint_steps

    p = argparse.ArgumentParser()
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--steps", default=None, help="comma list; default all")
    p.add_argument("--last_k", type=int, default=None)
    p.add_argument("--smoke", action="store_true", help="tiny model preset (tests)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = FlamingoTrainConfig.from_yaml(args.config) if args.config else FlamingoTrainConfig()
    if args.smoke:
        cfg.model_name = "test"
        cfg.audio_max_length = 16000
    template = build_state(cfg, smoke=args.smoke, device=device)
    steps = [int(s) for s in args.steps.split(",") if s] if args.steps else None
    soup, used = average_checkpoint_steps(args.ckpt_dir, template, steps=steps,
                                          last_k=args.last_k)
    out_step = max(used)
    save_checkpoint(args.output, soup, step=out_step)
    print(f"averaged steps {used} -> {args.output} @ step {out_step}")
    return soup


if __name__ == "__main__":
    main()
