"""Optimizers: AdamW with global-norm clipping and linear warmup/decay,
and the per-regime parameter freezing.

Port of ``avsl_tpu/train/optim.py``. The JAX package builds
``optax.multi_transform`` over path labels with ``set_to_zero`` for the
frozen group; here :func:`label_params` labels the model's named
parameters (OpenAI names joined with "."), and :class:`ClippedAdamW` holds
state for, and updates, only the TRAIN ones. It mirrors the optax chain
``clip_by_global_norm(clip_norm)`` then ``adamw(schedule)`` exactly:

* the global norm has no epsilon (unlike ``clip_grad_norm_``'s 1e-6):
  gradients pass unchanged when the norm is below ``clip_norm``, else
  become ``(g / norm) * clip_norm``;
* Adam moments ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``
  with bias correction, and eps outside the square root;
* weight decay on every trained tensor, scaled like the Adam term by the
  scheduled learning rate: ``p -= lr_t (mu_hat / (sqrt(nu_hat) + eps) +
  wd p)``;
* the schedule is read at the update count before the increment, so the
  first update has learning rate ``schedule(0) = 0``.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

TRAIN = "train"
FROZEN = "frozen"

# parameter-name patterns (regex, searched in the "."-joined name)
VIDEO_MODEL_PATTERNS = (r"video_model", r"visual_encoder")
VIDEO_PROJECTION_PATTERNS = (r"video_projection",)
GATED_X_ATTN_PATTERNS = (r"x_attn", r"x_mlp")

Schedule = Callable[[int], float]
# elements per chunk of the update, which bounds its temporaries
_CHUNK_ELEMENTS = 1 << 27


def label_params(
    model: nn.Module, trainable_patterns: Sequence[str], frozen_patterns: Sequence[str] = ()
) -> Dict[str, str]:
    """Label each named parameter TRAIN or FROZEN. A parameter trains iff
    it matches a trainable pattern and no frozen pattern (frozen wins)."""
    t_res = [re.compile(p) for p in trainable_patterns]
    f_res = [re.compile(p) for p in frozen_patterns]

    def label(name: str) -> str:
        if any(r.search(name) for r in f_res):
            return FROZEN
        return TRAIN if any(r.search(name) for r in t_res) else FROZEN

    return {name: label(name) for name, _ in model.named_parameters()}


def linear_warmup_decay(lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    """Linear warmup from 0 to ``lr`` over ``max(warmup_steps, 1)``
    updates, then linear decay to 0 at ``total_steps`` (optax
    ``join_schedules`` of two ``linear_schedule``s, in fp32)."""
    warm = max(warmup_steps, 1)
    decay = max(total_steps - warmup_steps, 1)

    def linear(init: float, end: float, steps: int, count: int) -> float:
        frac = np.float32(1.0) - np.float32(min(max(count, 0), steps)) / np.float32(steps)
        return float(np.float32(init - end) * frac + np.float32(end))

    def schedule(count: int) -> float:
        if count < warm:
            return linear(0.0, lr, warm, count)
        return linear(lr, 0.0, decay, count - warm)

    return schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all ``tensors``, fp32, on their
    device (no host sync)."""
    if not tensors:
        return torch.zeros(())
    norms = torch._foreach_norm([t.float() if t.dtype != torch.float32 else t for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class ClippedAdamW:
    """optax ``chain(clip_by_global_norm, adamw)`` over the TRAIN parameters.

    ``params`` are the trained tensors (updated in place by :meth:`step`);
    their moments are fp32 (or the parameter dtype) tensors on their
    device. Frozen parameters get neither state nor updates
    (``set_to_zero``)."""

    def __init__(
        self,
        params: Dict[str, torch.Tensor],
        schedule: Schedule,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 0.01,
        clip_norm: float = 1.0,
    ):
        self.names: List[str] = list(params)
        self.params: List[torch.Tensor] = [params[n] for n in self.names]
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.clip_norm = weight_decay, clip_norm
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def learning_rate(self) -> float:
        """The learning rate of the next update."""
        return self.schedule(self.count)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], grad_norm: Optional[torch.Tensor] = None) -> None:
        """One update from ``grads`` (aligned with :attr:`params`; they are
        overwritten). ``grad_norm`` is their global norm when the caller
        already has it."""
        grads = list(grads)
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        if not grads:
            self.count += 1
            return
        norm = global_norm(grads) if grad_norm is None else grad_norm
        # (g / norm) * clip_norm when norm >= clip_norm, else g unchanged
        below = norm < self.clip_norm
        divisor = torch.where(below, torch.ones_like(norm), norm)
        factor = torch.where(below, torch.ones_like(norm), torch.full_like(norm, self.clip_norm))
        count = self.count + 1
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count))
        lr = self.schedule(self.count)
        for lo, hi in self._chunks():
            g, p = grads[lo:hi], self.params[lo:hi]
            mu, nu = self.mu[lo:hi], self.nu[lo:hi]
            torch._foreach_div_(g, divisor.to(g[0].device))
            torch._foreach_mul_(g, factor.to(g[0].device))
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
            upd = torch._foreach_div(mu, bc1)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            torch._foreach_div_(upd, den)
            del den
            torch._foreach_add_(upd, p, alpha=self.weight_decay)
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(p, upd)
        self.count = count

    def _chunks(self):
        lo, size = 0, 0
        for i, p in enumerate(self.params):
            size += p.numel()
            if size >= _CHUNK_ELEMENTS:
                yield lo, i + 1
                lo, size = i + 1, 0
        if lo < len(self.params):
            yield lo, len(self.params)

    def state_dict(self) -> dict:
        return {"count": self.count, "names": list(self.names),
                "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        if list(state["names"]) != self.names:
            raise ValueError("optimizer state was saved for other parameters")
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
                dst.copy_(src)
        self.count = int(state["count"])


def _adamw(model: nn.Module, labels: Dict[str, str], cfg, t_total: int) -> ClippedAdamW:
    sched = linear_warmup_decay(float(cfg.learning_rate), int(cfg.warmup_steps), int(t_total))
    params = {n: p for n, p in model.named_parameters() if labels[n] == TRAIN}
    return ClippedAdamW(
        params, sched,
        b1=0.9,
        b2=float(getattr(cfg, "adam_beta2", 0.999)),
        eps=float(getattr(cfg, "adam_epsilon", 1e-8)),
        weight_decay=float(getattr(cfg, "weight_decay", 0.01)),
        clip_norm=float(getattr(cfg, "clip_norm", 1.0) or 1.0),
    )


def whisper_optimizer(model: nn.Module, cfg, t_total: int) -> Tuple[ClippedAdamW, Dict[str, str]]:
    """All-parameter AdamW (optionally still freezing the video model)."""
    frozen = VIDEO_MODEL_PATTERNS if getattr(cfg, "freeze_video_model", False) else ()
    labels = label_params(model, trainable_patterns=(r".*",), frozen_patterns=frozen)
    return _adamw(model, labels, cfg, t_total), labels


def whisper_video_projection_optimizer(model: nn.Module, cfg, t_total: int):
    """Train only the video projection (video_projection_train_only)."""
    labels = label_params(model, trainable_patterns=VIDEO_PROJECTION_PATTERNS)
    return _adamw(model, labels, cfg, t_total), labels


def whisper_flamingo_projection_optimizer(model: nn.Module, cfg, t_total: int):
    """Train gated x-attn sublayers + video projection; freeze the rest
    (including the AV-HuBERT video model)."""
    labels = label_params(
        model,
        trainable_patterns=GATED_X_ATTN_PATTERNS + VIDEO_PROJECTION_PATTERNS,
        frozen_patterns=VIDEO_MODEL_PATTERNS,
    )
    return _adamw(model, labels, cfg, t_total), labels


def select_optimizer(model: nn.Module, cfg, t_total: int):
    """Regime selection mirroring the reference's configure_optimizers.
    The two Flamingo regimes label correctly here but need the video slice
    (ROADMAP.md queue 1, items 6-8) to have anything to train."""
    if getattr(cfg, "add_gated_x_attn", 0):
        return whisper_flamingo_projection_optimizer(model, cfg, t_total)
    if getattr(cfg, "video_projection_train_only", False):
        return whisper_video_projection_optimizer(model, cfg, t_total)
    return whisper_optimizer(model, cfg, t_total)

