"""Loss closures binding the model to the train step.

Port of the audio branch of ``avsl_tpu/train/objectives.py::
flamingo_loss_fn``: SpecAugment on the mel (training only), the
teacher-forced forward with dropout in training, and token-mean CE over
the labels (-100 ignored). Batches follow the collator's layout:
``input_ids`` (mel [B, n_mels, T]), ``dec_input_ids``, ``labels`` and
``audio_frames``. Video inputs, the AV-mode mixing they feed, and the
hoisted ``enc_features`` path need the video slice and raise.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from avsl_tpu_torch.kernels.specaugment import spec_augment_batch
from avsl_tpu_torch.models.avhubert import cross_entropy_loss


def _video_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs the video tower and gated cross-attention: slice 3 of "
        "the port (ROADMAP.md queue 1, items 6-8)"
    )


def flamingo_loss_fn(model, train: bool = True, freeze_video_bn_stats: bool = False,
                     spec_augment: Optional[str] = None,
                     prob_av: float = 1.0, prob_a: float = 0.0):
    """CE loss for Whisper: encoder(mel) -> decoder(dec_input_ids).

    ``train`` puts the model in training mode (dropout on) and applies
    ``spec_augment`` ("ls-basic": one frequency and one time mask per
    item; "ls-double": two of each) to the mel. The returned
    ``loss_fn(batch, generator)`` gives ``(loss, metrics)`` and draws
    every random number from ``generator``. ``freeze_video_bn_stats``,
    ``prob_av`` and ``prob_a`` act on video inputs only, which raise
    here."""
    del freeze_video_bn_stats  # only read with video inputs
    mixing = prob_av < 1.0 or prob_a > 0.0

    def loss_fn(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator]):
        model.train(train)
        if "enc_features" in batch:
            raise NotImplementedError(
                "the hoisted enc_features path (flamingo_tower_precompute) needs "
                "the video slice (ROADMAP.md queue 1, item 8)"
            )
        if batch.get("video") is not None:
            raise _video_not_ported("video inputs" + (" with AV-mode mixing" if mixing else ""))
        mel = batch["input_ids"]
        if train and spec_augment in ("ls-basic", "ls-double"):
            n = 1 if spec_augment == "ls-basic" else 2
            frames = batch.get("audio_frames")
            if frames is None:
                frames = torch.full((mel.shape[0],), mel.shape[-1], dtype=torch.int64,
                                    device=mel.device)
            # mel is [B, n_mels, T]; SpecAugment works time-major
            mel = spec_augment_batch(mel.transpose(1, 2), generator, frames,
                                     n_freq_mask=n, n_time_mask=n).transpose(1, 2)
        logits = model(mel, batch["dec_input_ids"], generator=generator if train else None)
        return cross_entropy_loss(logits, batch["labels"], label_smoothing=0.0), {}

    return loss_fn
