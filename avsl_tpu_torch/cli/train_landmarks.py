"""Train the CNN landmark detector of the port: synthetic faces +
pseudo-labeled real footage.

Usage: ``python -m avsl_tpu_torch.cli.train_landmarks [--steps 3000]
[--n_train 20000] [--pseudo_video CLIP.mp4 ...]
[--out avsl_tpu_torch/data/assets/landmark_cnn.npz] [--device cuda|cpu]``

Port of ``avsl_tpu/cli/train_landmarks.py``. Samples come from
data/synthetic_faces.py (canonical 68-point layout under random
similarity transforms) plus, when ``--pseudo_video`` clips are given,
real frames pseudo-labeled by the RefinedMouthTracker under
crop/scale/photometric augmentation (``pseudo_label_dataset``, which
needs OpenCV). Batches are drawn by ``np.random.default_rng(seed)`` as in
JAX; the loss is L1 on normalized coordinates with 3x weight on the mouth
points 48..67; the optimizer is optax's ``adamw(warmup_cosine_decay_schedule
(0, lr, 100, steps), weight_decay=1e-4)`` (no clip, decay on every
tensor): :class:`~avsl_tpu_torch.train.optim.ClippedAdamW` with an
infinite clip over :func:`~avsl_tpu_torch.train.optim.warmup_cosine_decay`,
which refuses ``--steps`` of 100 or fewer, as optax does. Validation pixel
errors print every 500 steps. The weights are written in the JAX
package's flat ``.npz`` layout, which ``CNNLandmarkDetector`` of either
package loads. The initial weights are the port's random ones from
``--seed`` (flax's init draws others); :func:`train` takes any.

Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch


def train(
    params: Mapping[str, torch.Tensor],
    imgs: np.ndarray,
    lms: np.ndarray,
    val_imgs: np.ndarray,
    val_lms: np.ndarray,
    steps: int,
    batch_size: int = 64,
    lr: float = 1e-3,
    seed: int = 0,
    pseudo: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    pseudo_weight: float = 0.5,
    device="cuda",
) -> Tuple[torch.nn.Module, dict]:
    """``steps`` AdamW steps of :class:`LandmarkNet` from the state dict
    ``params`` on ``device``: images [N, 128, 128] in [0, 255], landmarks
    [N, 68, 2] in [0, 1]; each batch ``batch_size`` indices drawn from
    ``default_rng(seed)``, its last ``int(batch_size * pseudo_weight)``
    rows replaced by pseudo-labeled samples when ``pseudo`` is given (the
    indices drawn from the same generator). Returns the trained net and
    ``{"steps", "final_loss", "val_px_error", "val_mouth_px_error",
    "losses", "seconds"}``: every step's loss, and the loop's seconds
    (synchronised at its end)."""
    from avsl_tpu_torch.core.device import resolve_device
    from avsl_tpu_torch.data.landmarks import landmark_net
    from avsl_tpu_torch.train.optim import ClippedAdamW, warmup_cosine_decay

    dev = resolve_device(device)
    net = landmark_net(dev)
    net.load_state_dict(params)
    opt = ClippedAdamW(dict(net.named_parameters()), warmup_cosine_decay(0.0, lr, 100, steps),
                       b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4, clip_norm=math.inf)
    weights = np.ones((68, 1), np.float32)
    weights[48:68] = 3.0  # the mouth drives the crop
    weights = torch.from_numpy(weights / weights.mean()).to(dev)

    def on_device(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    @torch.no_grad()
    def val_err_px(x, y):
        pred = net(x)
        return (torch.mean(torch.abs(pred - y)) * 128,
                torch.mean(torch.abs(pred[:, 48:68] - y[:, 48:68])) * 128)

    rng = np.random.default_rng(seed)
    x_all, y_all = on_device(imgs[..., None] / 255.0), on_device(lms)
    xv, yv = on_device(val_imgs[..., None] / 255.0), on_device(val_lms)
    n_pseudo = 0
    if pseudo is not None:
        xp, yp = on_device(pseudo[0][..., None] / 255.0), on_device(pseudo[1])
        n_pseudo = int(batch_size * pseudo_weight)

    losses: List[torch.Tensor] = []
    t0 = time.time()
    for s in range(steps):
        idx = on_device(rng.integers(0, len(imgs), batch_size))
        xb, yb = x_all[idx], y_all[idx]
        if n_pseudo:
            pidx = on_device(rng.integers(0, len(xp), n_pseudo))
            xb = torch.cat([xb[n_pseudo:], xp[pidx]])
            yb = torch.cat([yb[n_pseudo:], yp[pidx]])
        loss = torch.mean(torch.abs(net(xb) - yb) * weights)
        net.zero_grad(set_to_none=True)
        loss.backward()
        opt.step([p.grad for p in opt.params])
        losses.append(loss.detach())
        if (s + 1) % 500 == 0:
            err, mouth_err = val_err_px(xv[:256], yv[:256])
            print(f"step {s+1}: loss {float(loss):.4f} val {float(err):.2f}px "
                  f"mouth {float(mouth_err):.2f}px ({(s+1)/(time.time()-t0):.1f} it/s)")
    history = torch.stack(losses).cpu().tolist() if losses else []
    seconds = time.time() - t0
    err, mouth_err = val_err_px(xv, yv)
    return net, {"steps": steps, "final_loss": history[-1] if history else float("nan"),
                 "val_px_error": float(err), "val_mouth_px_error": float(mouth_err),
                 "losses": history, "seconds": seconds}


def main(argv: Optional[List[str]] = None) -> dict:
    from avsl_tpu_torch.core.device import resolve_device
    from avsl_tpu_torch.data.landmarks import DEFAULT_CNN_WEIGHTS, landmark_net, save_cnn_params
    from avsl_tpu_torch.data.synthetic_faces import generate_dataset

    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--n_train", type=int, default=20000)
    p.add_argument("--n_val", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=DEFAULT_CNN_WEIGHTS)
    p.add_argument("--pseudo_video", action="append", default=[],
                   help="real clip(s) to pseudo-label with the refined "
                        "tracker and mix into training (repeatable)")
    p.add_argument("--pseudo_per_frame", type=int, default=8)
    p.add_argument("--pseudo_weight", type=float, default=0.5,
                   help="fraction of each batch drawn from pseudo samples")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.time()
    imgs, lms = generate_dataset(args.n_train, seed=args.seed)
    val_imgs, val_lms = generate_dataset(args.n_val, seed=args.seed + 1)
    print(f"generated {args.n_train}+{args.n_val} samples in {time.time()-t0:.0f}s")

    pseudo = None
    if args.pseudo_video:
        from avsl_tpu_torch.data.synthetic_faces import pseudo_label_dataset

        t0 = time.time()
        pseudo = pseudo_label_dataset(args.pseudo_video, per_frame=args.pseudo_per_frame,
                                      seed=args.seed + 2)
        print(f"pseudo-labeled {len(pseudo[0])} real samples from "
              f"{len(args.pseudo_video)} clip(s) in {time.time()-t0:.0f}s")
        if not len(pseudo[0]):
            pseudo = None

    init = landmark_net(device, args.seed).state_dict()
    net, result = train(init, imgs, lms, val_imgs, val_lms, args.steps, args.batch_size,
                        args.lr, args.seed, pseudo, args.pseudo_weight, device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_cnn_params(net.state_dict(), args.out)
    print("saved", args.out, {k: result[k] for k in ("steps", "final_loss", "val_px_error",
                                                     "val_mouth_px_error")})
    return result


if __name__ == "__main__":
    main()
