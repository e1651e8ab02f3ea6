"""Auto-AVSR audio-visual fine-tuning entry point of the port.

Usage: ``python -m avsl_tpu_torch.cli.auto_avsr_ft [--config auto_avsr_av.yaml]
[--steps N] [--batch_size B] [--smoke] [--device cuda|cpu]``

Trains Auto-AVSR's audio-visual Conformer (arXiv:2303.14307;
:mod:`avsl_tpu_torch.models.conformer`), built from auto_avsr's model
YAML (``configs/auto_avsr_av.yaml``) or ``AutoAVSRConfig()``, with the
joint CTC/attention loss (``train/objectives.py::auto_avsr_loss_fn``) on
a synthetic set of rows: raw 16 kHz PCM (640 samples a lip frame),
normalised lip frames and 3-7 label ids, 10 s a row. The optimizer is
auto_avsr's: global-norm clip 10, then AdamW (b1 0.9, b2 0.98, eps 1e-8,
weight decay 0.03 on every parameter) over a linear warmup from 0 over a
fifteenth of the steps and a cosine decay to 0
(``warmup_cosine_decay(0, lr, steps // 15, steps)``). Weights are fp32 and
the compute is the card's dtype (bf16); ``--smoke`` runs the tiny fp32
test model for 4 steps on rows of 12 frames. It prints one JSON line: ``steps``,
``first_loss``, ``last_loss``, ``eval_loss``, ``eval_loss_ctc`` and
``eval_loss_att``.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from avsl_tpu_torch.utils.spans import span

# PCM samples a lip frame (25 frames a second at 16 kHz)
SAMPLES_PER_FRAME = 640


def make_synthetic_raw_av_batchset(n: int, frames: int = 12, image: int = 24, vocab: int = 41,
                                   seed: int = 0) -> List[Dict[str, Any]]:
    """``n`` rows of seeded PCM [frames x 640], normalised lip frames
    [frames, image, image] and 3-7 label ids in [1, vocab - 1) (neither the
    blank nor sos/eos)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        rows.append({
            "audio": (0.1 * rng.normal(size=frames * SAMPLES_PER_FRAME)).astype(np.float32),
            "video": rng.normal(size=(frames, image, image)).astype(np.float32),
            "labels": rng.integers(1, vocab - 1, rng.integers(3, 8)).tolist(),
        })
    return rows


def collate_raw_av(rows, eos_id: int) -> Dict[str, np.ndarray]:
    """Pad rows (``audio`` PCM, ``video`` [T, H, W] normalised frames,
    ``labels``) to one batch: ``audio`` [B, S] and ``video`` [B, T, H, W]
    zero-padded with ``audio_lengths`` (samples) and ``video_lengths``;
    ``targets`` [B, L] zero-padded with ``target_lengths`` (the CTC's);
    ``dec_input_ids`` [B, L + 1] sos (``eos_id``) then the labels, padded
    with eos; ``labels`` [B, L + 1] the labels then eos, padded with -100."""
    with span("data.batch"):
        return _collate_raw_av(rows, eos_id)


def _collate_raw_av(rows, eos_id: int) -> Dict[str, np.ndarray]:
    b = len(rows)
    s = max(len(r["audio"]) for r in rows)
    t = max(len(r["video"]) for r in rows)
    length = max(len(r["labels"]) for r in rows)
    audio = np.zeros((b, s), np.float32)
    video = np.zeros((b, t) + tuple(rows[0]["video"].shape[1:]), np.float32)
    targets = np.zeros((b, length), np.int64)
    dec = np.full((b, length + 1), eos_id, np.int64)
    labels = np.full((b, length + 1), -100, np.int64)
    for i, r in enumerate(rows):
        audio[i, : len(r["audio"])] = r["audio"]
        video[i, : len(r["video"])] = r["video"]
        n = len(r["labels"])
        targets[i, :n] = r["labels"]
        dec[i, 1: n + 1] = r["labels"]
        labels[i, :n] = r["labels"]
        labels[i, n] = eos_id
    return {"audio": audio, "video": video,
            "audio_lengths": np.array([len(r["audio"]) for r in rows], np.int64),
            "video_lengths": np.array([len(r["video"]) for r in rows], np.int64),
            "targets": targets,
            "target_lengths": np.array([len(r["labels"]) for r in rows], np.int64),
            "dec_input_ids": dec, "labels": labels}


def make_optimizer(model, lr: float, warmup: int, steps: int):
    """auto_avsr's optimizer: ``clip_by_global_norm(10)`` then AdamW (b1
    0.9, b2 0.98, eps 1e-8, weight decay 0.03) over every parameter, on
    a linear warmup from 0 to ``lr`` over ``warmup`` updates and a cosine
    to 0 at ``steps``."""
    from avsl_tpu_torch.train.optim import ClippedAdamW, warmup_cosine_decay

    return ClippedAdamW(dict(model.named_parameters()),
                        warmup_cosine_decay(0.0, lr, warmup, steps),
                        b1=0.9, b2=0.98, eps=1e-8, weight_decay=0.03, clip_norm=10.0)


def batches(rows, batch_size: int, eos_id: int, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Full batches of ``rows`` in the order of ``default_rng(epoch)``."""
    order = np.random.default_rng(epoch).permutation(len(rows))
    for i in range(0, len(order) - batch_size + 1, batch_size):
        yield collate_raw_av([rows[j] for j in order[i: i + batch_size]], eos_id)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None, help="auto_avsr model YAML")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def train(args: argparse.Namespace):
    """The CLI's run on parsed flags ``args``: ``(result, state,
    metrics)``, the printed keys, the trained state and each step's
    metrics."""
    import torch

    from avsl_tpu_torch.core.config import AutoAVSRConfig
    from avsl_tpu_torch.core.device import resolve_device
    from avsl_tpu_torch.models import build_auto_avsr
    from avsl_tpu_torch.train import TrainState, make_train_step
    from avsl_tpu_torch.train.loop import batch_to_device
    from avsl_tpu_torch.train.objectives import auto_avsr_loss_fn

    frames = 250  # 10 s rows
    if args.smoke:
        cfg = AutoAVSRConfig.tiny_test(dtype="float32")
        args.steps, frames = 4, 12
    elif args.config:
        cfg = AutoAVSRConfig.from_yaml(args.config)
    else:
        cfg = AutoAVSRConfig()
    # auto_avsr warms up over 5 of its 75 epochs
    warmup = max(args.steps // 15, 1)
    device = resolve_device(args.device)

    rows = make_synthetic_raw_av_batchset(4 * args.batch_size, frames, cfg.image_crop_size,
                                          cfg.odim)
    probe = next(batches(rows, args.batch_size, cfg.eos_id))
    model = build_auto_avsr(cfg, device=device, seed=0)
    step = make_train_step(auto_avsr_loss_fn(model, train=True))
    state = TrainState.create(model, make_optimizer(model, args.lr, warmup, args.steps), seed=0)
    it, epoch, losses, history = batches(rows, args.batch_size, cfg.eos_id), 0, [], []
    for _ in range(args.steps):
        try:
            batch = next(it)
        except StopIteration:
            epoch += 1
            it = batches(rows, args.batch_size, cfg.eos_id, epoch)
            batch = next(it)
        state, metrics = step(state, batch)
        history.append(metrics)
        losses.append(float(metrics["loss"]))
    with torch.no_grad():
        loss, parts = auto_avsr_loss_fn(model, train=False)(batch_to_device(probe, device), None)
    result = {"steps": args.steps, "first_loss": losses[0], "last_loss": losses[-1],
              "eval_loss": float(loss), "eval_loss_ctc": float(parts["loss_ctc"]),
              "eval_loss_att": float(parts["loss_att"])}
    return result, state, history


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    result = train(parse_args(argv))[0]
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
