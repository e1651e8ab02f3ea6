"""HuBERT-style masked-cluster pretraining of the AV-HuBERT encoder.

Port of ``avsl_tpu/models/pretrain.py``: per-frame cluster targets (k-means
codes, :mod:`avsl_tpu_torch.data.clustering`), one or more target groups;
a span mask over the fused features, whose masked frames take the learned
``mask_emb``; the transformer output projected to ``final_dim`` per group
(``untie_final_proj``: a slice of ``final_proj`` each); logits = cosine
(or dot) similarity of that projection with each group's codebook rows,
over ``logit_temp``, in fp32; cross-entropy on the masked frames and on
the unmasked ones, plus a feature penalty on the fused features before
``layer_norm``.

The model keeps fairseq ``AVHubertModel``'s names: it is the encoder
(:class:`~avsl_tpu_torch.models.avhubert.AVHuBERTModel`, whose modules sit
at the top level) plus ``final_proj`` and ``label_embs_concat``, so a
fairseq-pretrained state dict loads as it is, and
:func:`~avsl_tpu_torch.train.checkpoints.partial_load` hands its encoder to
the fine-tune heads. Selection of masked and unmasked frames is by
weighting, as in JAX.

Under tensor parallelism (``core/partitioning.py``) ``final_proj`` runs
column-parallel with its output gathered, and ``label_embs_concat`` keeps
this model rank's rows of the classes (:meth:`set_class_parallel`): each
rank's similarities to its rows are all-gathered over the classes before
the softmax, as XLA gathers them.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from avsl_tpu_torch.core.config import AVHuBERTConfig
from avsl_tpu_torch.core.mesh import copy_to_group, gather_from_group
from avsl_tpu_torch.models.avhubert import AVHuBERTModel, _resolve_deterministic, span_mask
from avsl_tpu_torch.models.layers import CastLinear, torch_dtype

__all__ = ["AVHuBERTForPretraining", "extract_layer_features", "extracted_features_from",
           "pretrain_loss"]


class AVHuBERTForPretraining(AVHuBERTModel):
    """Encoder + masked-cluster prediction head. ``num_classes`` holds the
    codebook size of each target group.

    ``forward`` returns ``logits`` (a tuple with one fp32 [B, T, C_g] per
    group), the boolean time ``mask`` applied (drawn from ``generator``
    unless ``feature_mask`` is given; also in eval, where a pretraining
    run's validation measures masked prediction), ``padding_mask`` and,
    with ``targets``, the targets [B, T, G], each cut to the output length.
    The loss is :func:`pretrain_loss`. :meth:`encode` is the encoder's
    forward (``AVHuBERTModel``'s)."""

    def __init__(self, cfg: AVHuBERTConfig, num_classes: Sequence[int] = (500,), device=None):
        super().__init__(cfg, device=device)
        self.num_classes = tuple(int(c) for c in num_classes)
        pdtype = torch_dtype(cfg.param_dtype)
        out_dim = cfg.final_dim * len(self.num_classes) if cfg.untie_final_proj else cfg.final_dim
        self.final_proj = CastLinear(cfg.hidden_size, out_dim, device=device, param_dtype=pdtype,
                                     compute_dtype=torch_dtype(cfg.dtype))
        self.label_embs_concat = nn.Parameter(
            torch.empty(sum(self.num_classes), cfg.final_dim, device=device, dtype=pdtype))
        self.class_tp = None

    def set_class_parallel(self, group, rank: int, size: int) -> None:
        """Hold part ``rank`` of ``size`` of the codebook's rows over
        ``group``; ``core/partitioning.py::shard_state`` cuts them."""
        self.class_tp = (group, rank, size)

    @torch.no_grad()
    def init_from(self, generator: torch.Generator) -> None:
        """The encoder's own rule, then ``label_embs_concat`` from U[0, 1),
        as fairseq and JAX initialise it."""
        super().init_from(generator)
        self.label_embs_concat.uniform_(0.0, 1.0, generator=generator)

    def encode(self, **kw) -> torch.Tensor:
        """The encoder's forward (``AVHuBERTModel.forward``) on this model."""
        return AVHuBERTModel.forward(self, **kw)

    def extract_features(self, audio=None, video=None, padding_mask=None, **kw) -> torch.Tensor:
        return self.encode(audio=audio, video=video, padding_mask=padding_mask,
                           deterministic=True, **kw)

    def _group_logits(self, proj: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Per-group fp32 similarity logits over ``logit_temp`` (cosine: both
        sides normalised with their norms clamped at 1e-8)."""
        cfg = self.cfg
        if cfg.sim_type not in ("cosine", "dot"):
            raise ValueError(f"Unknown sim_type {cfg.sim_type!r}")
        logits, start = [], 0
        group = None if self.class_tp is None else self.class_tp[0]
        for g, n_cls in enumerate(self.num_classes):
            p = proj[..., g * cfg.final_dim:(g + 1) * cfg.final_dim] if cfg.untie_final_proj \
                else proj
            # split over classes: this rank's rows of every group, all-gathered after
            emb = self.label_embs_concat if group is not None else \
                self.label_embs_concat[start:start + n_cls]
            p, emb = p.float(), emb.float()
            if cfg.sim_type == "cosine":
                p = p / torch.linalg.vector_norm(p, dim=-1, keepdim=True).clamp_min(1e-8)
                emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True).clamp_min(1e-8)
            if group is None:
                logits.append(torch.einsum("btd,cd->btc", p, emb) / cfg.logit_temp)
            else:
                local = torch.einsum("btd,cd->btc", copy_to_group(p, group), emb) / cfg.logit_temp
                logits.append(gather_from_group(local, group, -1)[..., start:start + n_cls])
            start += n_cls
        return tuple(logits)

    def forward(self, audio=None, video=None, targets=None, padding_mask=None,
                audio_present=None, video_present=None, feature_mask=None,
                deterministic: Optional[bool] = None, use_running_average=None,
                generator: Optional[torch.Generator] = None) -> Dict[str, object]:
        cfg = self.cfg
        deterministic = _resolve_deterministic(self, deterministic)
        src = audio if audio is not None else video
        b, t_in = src.shape[0], src.shape[1]
        channel_mask = None
        if feature_mask is None:
            # drawn here, not inside the encoder, so the loss sees which
            # frames were masked; the fine-tune masking's rates
            prob, span = ((cfg.mask_prob_audio, cfg.mask_length_audio) if audio is not None
                          else (cfg.mask_prob_image, cfg.mask_length_image))
            feature_mask = span_mask(generator, b, t_in, prob, span, padding_mask,
                                     device=src.device)
            if cfg.mask_feature_prob > 0.0 and not deterministic:
                channel_mask = span_mask(generator, b, cfg.hidden_size, cfg.mask_feature_prob,
                                         cfg.mask_feature_length, device=src.device)
        feature_mask = torch.as_tensor(feature_mask, device=src.device).bool()
        x = self.encode(audio=audio, video=video, padding_mask=padding_mask,
                        audio_present=audio_present, video_present=video_present,
                        feature_mask=feature_mask, channel_mask=channel_mask,
                        deterministic=deterministic, use_running_average=use_running_average,
                        generator=generator)
        t_out = x.shape[1]
        out: Dict[str, object] = {
            "logits": self._group_logits(self.final_proj(x)),
            "mask": feature_mask[:, :t_out],
            "padding_mask": None if padding_mask is None else padding_mask[:, :t_out],
        }
        if targets is not None:
            targets = torch.as_tensor(targets, device=src.device)
            if targets.ndim == 2:
                targets = targets[..., None]
            out["targets"] = targets[:, :t_out, :]
        return out


def pretrain_loss(
    outputs: Mapping[str, object],
    cfg: AVHuBERTConfig,
    targets: Optional[torch.Tensor] = None,
    masked_weight: float = 1.0,
    nomask_weight: float = 1.0,
    feature_pen: Optional[torch.Tensor] = None,
    feature_pen_weight: float = 10.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked and unmasked cluster-prediction cross-entropy (fairseq
    HubertCriterion's ``pred_masked_weight``/``pred_nomask_weight``, the
    config's ``skip_masked``/``skip_nomask`` gates), each the mean over its
    selected (and unpadded) frames, summed over groups; plus
    ``feature_pen_weight`` times the mean square of ``feature_pen``.
    Returns ``(loss, metrics)`` with ``loss_m``, ``loss_u``, ``acc_m``,
    ``acc_u`` (accuracies averaged over groups) and, with a penalty,
    ``features_pen``."""
    if targets is None:
        targets = outputs["targets"]
    if targets.ndim == 2:
        targets = targets[..., None]
    mask = outputs["mask"].bool()
    padding = outputs["padding_mask"]
    valid = torch.ones_like(mask) if padding is None else padding.to(mask.device).bool()
    m_sel = (mask & valid).float()
    u_sel = (~mask & valid).float()

    def group_ce(logits_g, tgt_g, sel):
        logp = torch.log_softmax(logits_g.float(), dim=-1)
        nll = -logp.gather(-1, tgt_g[..., None].long())[..., 0]
        denom = sel.sum().clamp_min(1.0)
        acc = ((logits_g.argmax(dim=-1) == tgt_g).float() * sel).sum() / denom
        return (nll * sel).sum() / denom, acc

    zero = torch.zeros((), device=mask.device)
    loss_m = loss_u = acc_m = acc_u = zero
    n_groups = len(outputs["logits"])
    for g, logits_g in enumerate(outputs["logits"]):
        tgt_g = targets[..., g].to(logits_g.device)
        if not cfg.skip_masked:
            ce, acc = group_ce(logits_g, tgt_g, m_sel)
            loss_m, acc_m = loss_m + ce, acc_m + acc / n_groups
        if not cfg.skip_nomask:
            ce, acc = group_ce(logits_g, tgt_g, u_sel)
            loss_u, acc_u = loss_u + ce, acc_u + acc / n_groups
    loss = masked_weight * loss_m + nomask_weight * loss_u
    metrics = {"loss_m": loss_m, "loss_u": loss_u, "acc_m": acc_m, "acc_u": acc_u}
    if feature_pen is not None:
        pen = feature_pen.float().square().mean()
        loss = loss + feature_pen_weight * pen
        metrics["features_pen"] = pen
    return loss, metrics


@torch.no_grad()
def extract_layer_features(model: AVHuBERTForPretraining, layer: int, audio=None, video=None,
                           padding_mask=None) -> torch.Tensor:
    """Unmasked layer-``layer`` hidden states [B, T, D] (1-indexed, before
    the final norm; fairseq ``extract_features(output_layer=k)``), the
    clustering features of HuBERT iterations 2+. Runs in eval mode and
    puts the model's mode back after."""
    was_training = model.training
    model.eval()
    try:
        return model.extract_features(audio=audio, video=video, padding_mask=padding_mask,
                                      output_layer=layer)
    finally:
        model.train(was_training)


def extracted_features_from(intermediates: Mapping) -> Optional[torch.Tensor]:
    """The encoder's fused features before ``layer_norm`` from a collector
    (:func:`~avsl_tpu_torch.models.intermediates.collect_intermediates`),
    the first sown; None when none was."""
    found = intermediates.get("extracted_features")
    return found[0] if found else None
