"""Loss closures binding the model to the train step.

Port of ``flamingo_loss_fn``, ``flamingo_tower_precompute``,
``avhubert_seq2seq_loss_fn``, ``avhubert_ctc_loss_fn`` and
``avhubert_pretrain_loss_fn`` from ``avsl_tpu/train/objectives.py``, and
the port's own ``auto_avsr_loss_fn`` (Auto-AVSR's joint CTC/attention
loss, :mod:`avsl_tpu_torch.models.conformer`). Whisper(-Flamingo):
SpecAugment on the mel (training only),
the train-time AV-mode draw, the teacher-forced forward with every
training draw on, and token-mean CE over the labels (-100 ignored).
Batches follow the collator's layout: ``input_ids`` (mel [B, n_mels, T]),
``dec_input_ids``, ``labels``, ``audio_frames``, and with lip video
``video`` [B, T, H, W, 1] and ``video_mask`` [B, T]. With the frozen-tower
hoist the batch also carries the precomputed context (``enc_features``,
``video_feats``, ``video_scale``) and the loss runs only the trainable
tail. AV-HuBERT: the label-smoothed CE of the seq2seq head on
teacher-forced ``dec_input_ids``, or the CTC loss of the CTC head, with
every training draw on and BatchNorm on the batch's statistics; the
masked-cluster pretraining loss with its feature penalty. With an MoE
encoder (``n_experts > 0``, in an AV-HuBERT model or a Flamingo model's
video tower) each loss reads the Switch balance loss the forward sows
(:func:`~avsl_tpu_torch.models.moe.moe_aux_loss`), adds ``moe_aux_coef``
times it in training only and reports it as ``metrics["moe_aux"]``; the
hoisted Flamingo loss runs no tower and has none.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from avsl_tpu_torch.kernels.specaugment import spec_augment_batch
from avsl_tpu_torch.models.avhubert import cross_entropy_loss, ctc_loss
from avsl_tpu_torch.models.conformer import joint_loss
from avsl_tpu_torch.models.intermediates import collect_intermediates
from avsl_tpu_torch.models.moe import moe_aux_loss
from avsl_tpu_torch.models.pretrain import extracted_features_from, pretrain_loss
from avsl_tpu_torch.utils.spans import span


def _add_moe_aux(loss, metrics, intermediates, train: bool, coef: float):
    """``loss + coef * aux`` in training (the eval loss stays comparable
    across configs), with ``metrics["moe_aux"]``, when the forward sowed a
    balance loss; ``loss`` as it is otherwise."""
    if "moe_aux" not in intermediates:
        return loss
    aux = moe_aux_loss(intermediates)
    metrics["moe_aux"] = aux
    return loss + coef * aux if train else loss


def _spec_augment(mel: torch.Tensor, frames: Optional[torch.Tensor],
                  generator: torch.Generator, policy: Optional[str]) -> torch.Tensor:
    """``policy`` ("ls-basic": one frequency and one time mask per item;
    "ls-double": two of each) on mel [B, n_mels, T]; other policies leave
    it as it is."""
    if policy not in ("ls-basic", "ls-double"):
        return mel
    n = 1 if policy == "ls-basic" else 2
    if frames is None:
        frames = torch.full((mel.shape[0],), mel.shape[-1], dtype=torch.int64, device=mel.device)
    # SpecAugment works time-major
    return spec_augment_batch(mel.transpose(1, 2), generator, frames,
                              n_freq_mask=n, n_time_mask=n).transpose(1, 2)


def _av_mode(generator: torch.Generator, shape: Tuple[int, ...], device,
             prob_av: float, prob_a: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One AV-mode draw ``u`` per entry of ``shape``: AV with probability
    ``prob_av``, audio-only with ``prob_a`` (the projected video scaled by
    0), else video-only (the mel zeroed). Returns ``(video_scale,
    keep_audio)``, fp32."""
    u = torch.rand(shape, generator=generator, device=device)
    audio_only = (u >= prob_av) & (u < prob_av + prob_a)
    return (torch.where(audio_only, 0.0, 1.0).to(device),
            (u < prob_av + prob_a).float())


def flamingo_loss_fn(model, train: bool = True, freeze_video_bn_stats: bool = False,
                     spec_augment: Optional[str] = None,
                     prob_av: float = 1.0, prob_a: float = 0.0, moe_aux_coef: float = 0.01):
    """CE loss for Whisper(-Flamingo): encoder(mel, video) -> decoder.

    ``train`` puts the model in training mode (dropout, the tower's
    LayerDrop, BatchNorm on the batch's statistics unless
    ``freeze_video_bn_stats``) and applies ``spec_augment`` to the mel.
    With video in training and ``prob_av < 1`` or ``prob_a > 0``, one
    AV-mode draw a micro-step picks AV, audio-only (``video_feature_scale``
    0: the tower still sees the real clip, so BatchNorm keeps a
    real-statistics batch) or video-only (the mel multiplied by 0), as
    ``objectives.py:118-126`` does. A batch holding ``enc_features`` comes
    from :func:`flamingo_tower_precompute`: only ``project_and_decode``
    runs, and an MoE tower's balance loss is skipped there (the frozen
    router takes no gradient). The returned ``loss_fn(batch, generator)``
    gives ``(loss, metrics)`` and draws every random number from
    ``generator``."""
    mixing = prob_av < 1.0 or prob_a > 0.0

    def loss_fn(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator]):
        model.train(train)
        gen = generator if train else None
        if "enc_features" in batch:
            logits = model.project_and_decode(
                batch["dec_input_ids"], batch["enc_features"],
                video_feats=batch.get("video_feats"),
                video_feature_scale=batch.get("video_scale"), generator=gen)
            return cross_entropy_loss(logits, batch["labels"], label_smoothing=0.0), {}
        mel = batch["input_ids"]
        if train:
            mel = _spec_augment(mel, batch.get("audio_frames"), generator, spec_augment)
        video, video_scale = batch.get("video"), None
        if train and video is not None and mixing:
            video_scale, keep_audio = _av_mode(generator, (), mel.device, prob_av, prob_a)
            mel = mel * keep_audio.to(mel.dtype)
        with collect_intermediates() as inter:
            logits = model(mel, batch["dec_input_ids"], video=video,
                           video_mask=batch.get("video_mask"), generator=gen,
                           video_feature_scale=video_scale,
                           freeze_video_bn_stats=freeze_video_bn_stats)
        metrics: Dict[str, torch.Tensor] = {}
        loss = cross_entropy_loss(logits, batch["labels"], label_smoothing=0.0)
        return _add_moe_aux(loss, metrics, inter, train, moe_aux_coef), metrics

    return loss_fn


def flamingo_tower_precompute(model, train: bool = True, freeze_video_bn_stats: bool = True,
                              spec_augment: Optional[str] = None,
                              prob_av: float = 1.0, prob_a: float = 0.0):
    """The frozen-tower forward for :func:`flamingo_loss_fn`, batched over
    every micro-step of a step (``objectives.py:157-253``).

    The returned ``pre_fn(batch, generator) -> ctx`` runs the Whisper
    encoder and the video tower once, without gradients, over the stacked
    ``[accum, micro, ...]`` batch flattened to ``[accum * micro, ...]``,
    with SpecAugment and one AV-mode draw per micro-step made here, and
    returns ``enc_features``, ``video_feats`` and ``video_scale`` with a
    leading ``[accum]`` axis for the train step to merge into each
    micro-batch. Valid only when everything the towers read is frozen and
    the tower's BatchNorm uses its running statistics; the caller gates on
    that (``cli/finetune.py``). The draws are made in another order than
    in-scan, with the same distribution; a tower LayerDrop above 0 draws
    once for all the micro-steps of a step."""

    mixing = prob_av < 1.0 or prob_a > 0.0

    @torch.no_grad()
    def pre_fn(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator]):
        model.train(train)
        mel, dec = batch["input_ids"], batch["dec_input_ids"]
        stacked = dec.ndim == 3  # [accum, micro, L] vs [micro, L]
        a = mel.shape[0] if stacked else 1

        def flat(x):
            return x.reshape((-1,) + tuple(x.shape[2:])) if stacked and x is not None else x

        def unflat(x):
            return x.reshape((a, -1) + tuple(x.shape[1:])) if stacked and x is not None else x

        mel_f = flat(mel)
        if train:
            mel_f = _spec_augment(mel_f, flat(batch.get("audio_frames")), generator, spec_augment)
        video, ctx = batch.get("video"), {}
        if train and video is not None and mixing:
            # one mode draw per micro-step, as the in-scan path makes
            ctx["video_scale"], keep_audio = _av_mode(
                generator, (a,) if stacked else (), mel_f.device, prob_av, prob_a)
            keep_audio = keep_audio.to(mel_f.dtype).reshape(-1)
            if stacked:
                keep_audio = keep_audio.repeat_interleave(mel_f.shape[0] // a)
            mel_f = mel_f * keep_audio[:, None, None]
        features, v = model.encode_towers(
            mel_f, video=flat(video), video_mask=flat(batch.get("video_mask")),
            generator=generator if train else None,
            freeze_video_bn_stats=freeze_video_bn_stats,
        )
        ctx["enc_features"] = unflat(features)
        if v is not None:
            ctx["video_feats"] = unflat(v)
        return ctx

    return pre_fn


def avhubert_seq2seq_loss_fn(model, train: bool = True, label_smoothing: Optional[float] = None,
                             moe_aux_coef: float = 0.01):
    """Label-smoothed CE (``cfg.label_smoothing`` unless given) of an
    ``AVHuBERTForSpeech2Text`` on a batch with ``dec_input_ids`` and
    ``labels`` (-100 ignored), ``audio`` and/or ``video``, and optionally
    ``padding_mask``, ``audio_present`` and ``video_present``. ``train``
    puts the model in training mode (dropouts, LayerDrop, modality dropout,
    BatchNorm on the batch's statistics). Returns ``loss_fn(batch,
    generator) -> (loss, metrics)``."""
    smoothing = model.cfg.label_smoothing if label_smoothing is None else label_smoothing

    def loss_fn(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator]):
        model.train(train)
        with collect_intermediates() as inter:
            out = model(audio=batch.get("audio"), video=batch.get("video"),
                        decoder_input_ids=batch["dec_input_ids"],
                        padding_mask=batch.get("padding_mask"),
                        audio_present=batch.get("audio_present"),
                        video_present=batch.get("video_present"),
                        generator=generator if train else None)
        metrics: Dict[str, torch.Tensor] = {}
        loss = cross_entropy_loss(out["logits"], batch["labels"], label_smoothing=smoothing)
        return _add_moe_aux(loss, metrics, inter, train, moe_aux_coef), metrics

    return loss_fn


def avhubert_ctc_loss_fn(model, train: bool = True, moe_aux_coef: float = 0.01):
    """CTC loss (blank = pad id, the zero-length guard) of an
    ``AVHuBERTForCTC`` on a batch with ``labels`` [B, L] token ids,
    ``label_padding`` [B, L] (1 = PAD), ``audio`` and/or ``video``,
    optionally ``padding_mask`` and ``logit_padding`` [B, T'] (1 = padded
    frame; no padding when absent). Returns ``loss_fn(batch, generator)
    -> (loss, metrics)``."""

    def loss_fn(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator]):
        model.train(train)
        with collect_intermediates() as inter:
            logits = model(audio=batch.get("audio"), video=batch.get("video"),
                           padding_mask=batch.get("padding_mask"),
                           generator=generator if train else None)
        logit_padding = batch.get("logit_padding")
        if logit_padding is None:
            logit_padding = torch.zeros(logits.shape[:2], device=logits.device)
        loss = ctc_loss(logits, logit_padding, batch["labels"], batch["label_padding"],
                        blank_id=model.cfg.pad_token_id)
        metrics: Dict[str, torch.Tensor] = {}
        return _add_moe_aux(loss, metrics, inter, train, moe_aux_coef), metrics

    return loss_fn


def avhubert_pretrain_loss_fn(model, train: bool = True, masked_weight: float = 1.0,
                              nomask_weight: float = 1.0, feature_pen_weight: float = 10.0,
                              moe_aux_coef: float = 0.01):
    """Masked-cluster prediction loss of an ``AVHuBERTForPretraining``
    (:func:`~avsl_tpu_torch.models.pretrain.pretrain_loss`) on a batch with
    ``audio`` and/or ``video``, ``targets`` [B, T] (or [B, T, G]) cluster
    ids and optionally ``padding_mask``, ``audio_present`` and
    ``video_present``: fairseq HubertCriterion's weights, the feature
    penalty on the fused features before ``layer_norm`` times
    ``feature_pen_weight``. The span mask is drawn from ``generator`` in
    eval too (validation measures masked prediction, as fairseq's does),
    so the eval loss needs one as well. Returns ``loss_fn(batch,
    generator) -> (loss, metrics)``."""

    def loss_fn(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator]):
        if generator is None:
            raise ValueError("the pretraining loss draws its span mask in eval too: "
                             "pass a torch.Generator")
        model.train(train)
        with collect_intermediates() as inter:
            out = model(audio=batch.get("audio"), video=batch.get("video"),
                        targets=batch["targets"], padding_mask=batch.get("padding_mask"),
                        audio_present=batch.get("audio_present"),
                        video_present=batch.get("video_present"), generator=generator)
        loss, metrics = pretrain_loss(out, model.cfg, masked_weight=masked_weight,
                                      nomask_weight=nomask_weight,
                                      feature_pen=extracted_features_from(inter),
                                      feature_pen_weight=feature_pen_weight)
        return _add_moe_aux(loss, metrics, inter, train, moe_aux_coef), metrics

    return loss_fn


def auto_avsr_loss_fn(model, train: bool = True):
    """Auto-AVSR's joint loss (:func:`~avsl_tpu_torch.models.conformer.joint_loss`)
    of an :class:`~avsl_tpu_torch.models.conformer.AutoAVSR` on a batch with
    ``video`` [B, T, H, W] normalised lip frames, ``audio`` [B, S] PCM,
    ``video_lengths`` and ``audio_lengths`` (samples), ``targets`` [B, L]
    and ``target_lengths`` (the CTC's), ``dec_input_ids`` (sos, then the
    targets, eos-padded) and ``labels`` (the targets, eos, -100-padded).
    ``train`` puts the model in training mode (every dropout, BatchNorm on
    the batch's statistics). The fusion, both heads and the loss run in the
    span ``avsr.head``. Returns ``loss_fn(batch, generator) -> (loss,
    {"loss_ctc", "loss_att"})``."""

    def loss_fn(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator]):
        model.train(train)
        gen = generator if train else None
        v, a, valid = model.encode(batch["video"], batch["audio"], batch.get("video_lengths"),
                                   batch.get("audio_lengths"), gen)
        with span("avsr.head"):
            ctc_logits, logits = model.heads(v, a, valid, batch["dec_input_ids"], gen)
            loss, loss_ctc, loss_att = joint_loss(model.cfg, ctc_logits, logits, valid, batch)
        return loss, {"loss_ctc": loss_ctc, "loss_att": loss_att}

    return loss_fn
