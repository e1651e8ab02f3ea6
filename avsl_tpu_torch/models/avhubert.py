"""AV-HuBERT model family of the port; for now only its loss.

Port of ``avsl_tpu/models/avhubert.py::cross_entropy_loss``, which the
Whisper fine-tuning objective also uses. The AV-HuBERT encoder, heads and
CTC loss belong to later slices (ROADMAP.md queue 1, items 6 and 9).
"""

from __future__ import annotations

import torch


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    label_smoothing: float = 0.0,
    ignore_index: int = -100,
) -> torch.Tensor:
    """Token-mean CE with label smoothing, ignoring ``ignore_index``.

    fp32 log-softmax over the last axis; the smoothed term is the mean
    negative log-probability over the vocabulary; the sum over valid
    tokens is divided by ``max(count, 1)``, so a batch with no valid
    label gives 0."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(log_probs, -1, safe[..., None].long())[..., 0]
    if label_smoothing > 0.0:
        smooth = -log_probs.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    nll = torch.where(valid, nll, torch.zeros((), device=nll.device))
    return nll.sum() / valid.sum().clamp_min(1)
