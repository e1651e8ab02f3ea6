"""AV-HuBERT in PyTorch: the video-only encoder that Whisper-Flamingo uses
as its video tower, and the token cross-entropy.

Port of ``avsl_tpu/models/avhubert.py`` for lip video, in inference and in
training: ``AVHuBERTVisualEncoder`` (the ResNet frontend, ``grad_multiply``
by ``feature_grad_mult`` and the projection), ``ConvPositionalEmbedding``
(the weight-normed grouped positional conv), ``AVHuBERTTransformerEncoder``
(pre-norm blocks whose self-attention runs the flash-attention kernel with
per-row key lengths; in training, dropout after ``pos_conv``, dropout,
attention dropout and activation dropout in the blocks, and LayerDrop),
the video-only path of ``AVHuBERTEncoderWrapper`` (``use_audio=False``,
``modality_fuse="add"``: the fused features are the visual features, then
``fuse_ln``, ``post_extract_proj`` and ``dropout_input``; modality dropout
in training) and ``AVHuBERTModel`` with ``extract_features``. Also
``cross_entropy_loss``, which the Whisper fine-tuning objective uses.

Training follows the JAX modules' ``deterministic`` argument, here None
by default and then the module's own mode (``model.train()``); random
draws come from the ``generator`` the forward is given. BatchNorm uses the
batch's statistics (and updates the running ones) when
``use_running_average`` is False, which it is by default in training. In
training the blocks' attention dropout sends their self-attention down
the unfused path, which ignores the key lengths, as the JAX layer does
(``avsl_tpu/models/layers.py:301-310``).

State-dict names are fairseq AV-HuBERT's (``feature_extractor_video.*``,
``layer_norm``, ``post_extract_proj``, ``mask_emb``, ``encoder.pos_conv.0.*``,
``encoder.layers.N.{self_attn.{q,k,v,out}_proj, self_attn_layer_norm, fc1,
fc2, final_layer_norm}``, ``encoder.layer_norm``), so the wrapper's
modules sit on :class:`AVHuBERTModel` itself, as they do in fairseq.

What this path does not take raises ``NotImplementedError`` naming its
``ROADMAP.md`` item: the audio frontend, presence flags, concat and
weighted-sum fusion, external feature or channel masks and the heads
(item 9), and span masking (``apply_time_mask``, item 12 with the
pretraining model).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from avsl_tpu_torch.core.config import AVHuBERTConfig
from avsl_tpu_torch.models.layers import (
    CastLinear,
    LayerNormF32,
    TransformerBlock,
    cast_param,
    grad_multiply,
    residual_dropout,
    torch_dtype,
)
from avsl_tpu_torch.models.resnet3d import ResNet3DFrontend


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md queue 1, {item})")


def _resolve_deterministic(module: nn.Module, deterministic: Optional[bool]) -> bool:
    """The JAX ``deterministic`` flag: the module's mode when None; an
    explicit value must agree with it, since the mode switches the
    dropouts of every submodule."""
    if deterministic is None:
        return not module.training
    if bool(deterministic) == module.training:
        raise ValueError(f"deterministic={deterministic} in {'train' if module.training else 'eval'}"
                         " mode: call model.train() or model.eval() to switch the tower's mode")
    return bool(deterministic)


def _dtypes(cfg: AVHuBERTConfig):
    """(compute dtype, parameter dtype) of ``cfg``."""
    return torch_dtype(cfg.dtype), torch_dtype(cfg.param_dtype)


class AVHuBERTVisualEncoder(nn.Module):
    """ResNet-3D lip frontend -> hidden_size features (1:1 with frames);
    fairseq's ``feature_extractor_video`` (``resnet`` and ``proj``). The
    frontend's gradient is scaled by ``feature_grad_mult``."""

    def __init__(self, cfg: AVHuBERTConfig, device=None):
        super().__init__()
        dtype, pdtype = _dtypes(cfg)
        self.feature_grad_mult = cfg.feature_grad_mult
        self.resnet = ResNet3DFrontend(
            cfg.visual_frontend_channels, cfg.visual_backbone_channels, cfg.resnet_relu_type,
            dtype=dtype, param_dtype=pdtype, device=device,
        )
        self.proj = CastLinear(cfg.visual_backbone_channels, cfg.hidden_size, device=device,
                               param_dtype=pdtype, compute_dtype=dtype)

    def forward(self, video: torch.Tensor, use_running_average: bool = True) -> torch.Tensor:
        feats = self.resnet(video, use_running_average)
        if self.feature_grad_mult != 1.0:
            feats = grad_multiply(feats, self.feature_grad_mult)
        return self.proj(feats)


class WeightNormConv1d(nn.Module):
    """Grouped Conv1d under flax ``nn.WeightNorm``'s parametrisation: the
    kernel is ``weight_g * weight_v / ||weight_v||`` with the norm taken per
    output channel (over input channels and taps; torch
    ``weight_norm(dim=0)``). ``weight_g`` [out, 1, 1] and ``weight_v`` [out,
    in/groups, k] are fp32 and the kernel is computed in fp32, then cast
    once to the compute dtype; the bias lives in ``param_dtype``."""

    def __init__(self, channels: int, kernel: int, groups: int, dtype=torch.bfloat16,
                 param_dtype=None, device=None):
        super().__init__()
        self.dtype, self.groups, self.padding = dtype, groups, kernel // 2
        f32 = dict(device=device, dtype=torch.float32)
        self.weight_g = nn.Parameter(torch.empty(channels, 1, 1, **f32))
        self.weight_v = nn.Parameter(torch.empty(channels, channels // groups, kernel, **f32))
        self.bias = nn.Parameter(torch.empty(channels, device=device, dtype=param_dtype or dtype))

    @torch.no_grad()
    def init_from(self, generator: torch.Generator) -> None:
        """flax's initialisation: unit scale per channel, a fan-in-scaled
        normal direction, a zero bias."""
        v = self.weight_v
        v.normal_(0.0, 1.0 / math.sqrt(v[0].numel()), generator=generator)
        self.weight_g.fill_(1.0)
        self.bias.zero_()

    def kernel(self) -> torch.Tensor:
        """The effective kernel in fp32 (flax: eps 1e-12 under the root)."""
        v = self.weight_v
        return v * torch.rsqrt(v.pow(2).sum(dim=(1, 2), keepdim=True) + 1e-12) * self.weight_g

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.kernel().to(self.dtype), cast_param(self.bias, self.dtype),
                        padding=self.padding, groups=self.groups)


class ConvPositionalEmbedding(nn.Sequential):
    """Weight-normed grouped temporal conv + GELU (wav2vec2's positional
    conv), fairseq's ``pos_conv`` whose conv is entry 0. [B, T, C] ->
    [B, T, C]; an even kernel pads k/2 on both sides and drops the last
    step."""

    def __init__(self, cfg: AVHuBERTConfig, device=None):
        dtype, pdtype = _dtypes(cfg)
        super().__init__(WeightNormConv1d(cfg.hidden_size, cfg.conv_pos, cfg.conv_pos_groups,
                                          dtype=dtype, param_dtype=pdtype, device=device))
        self.even = cfg.conv_pos % 2 == 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pos = self[0](x.transpose(1, 2))
        if self.even:
            pos = pos[..., :-1]
        return F.gelu(pos).transpose(1, 2)


class AVHuBERTTransformerEncoder(nn.Module):
    """Pre-norm (``layer_norm_first``) transformer encoder with padding
    zeroing, fairseq's ``encoder``: padded steps (``padding_mask`` False)
    are zeroed before ``pos_conv``, the self-attention masks keys past each
    row's valid length (the kernel's ``lengths``), and ``layer_norm`` runs
    after the stack (before it when not ``layer_norm_first``). In training
    (``model.train()``): dropout at ``hidden_dropout`` after the positional
    conv, the blocks' own dropouts, and LayerDrop: one draw a layer a
    forward, shared by the batch, keeping the layer's output or its input
    with ``torch.where`` on the device (no host sync)."""

    def __init__(self, cfg: AVHuBERTConfig, device=None):
        super().__init__()
        if cfg.n_experts > 0:
            raise _not_ported("n_experts > 0 (the MoE encoder FFN)", "item 12: models/moe.py")
        dtype, pdtype = _dtypes(cfg)
        self.layer_norm_first = cfg.layer_norm_first
        self.hidden_dropout, self.layerdrop = cfg.hidden_dropout, cfg.layerdrop
        self.pos_conv = ConvPositionalEmbedding(cfg, device=device)
        self.layers = nn.ModuleList(
            TransformerBlock(
                cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
                pre_norm=cfg.layer_norm_first, use_k_bias=True, names="fairseq",
                dtype=dtype, param_dtype=pdtype, device=device, dropout=cfg.hidden_dropout,
                attention_dropout=cfg.attention_dropout,
                activation_dropout=cfg.activation_dropout,
            )
            for _ in range(cfg.num_hidden_layers)
        )
        self.layer_norm = LayerNormF32(cfg.hidden_size, device=device)

    def forward(
        self,
        x: torch.Tensor,
        padding_mask: Optional[torch.Tensor] = None,  # [B, T] True = valid
        output_layer: Optional[int] = None,  # 1-indexed tap, skips the final norm
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        kv_lengths = None
        if padding_mask is not None:
            x = x * padding_mask[..., None].to(x.dtype)
            kv_lengths = padding_mask.sum(dim=-1, dtype=torch.int32)
        x = x + self.pos_conv(x)
        if not self.layer_norm_first:
            x = self.layer_norm(x)
        x = residual_dropout(x, self.hidden_dropout, self.training, generator)
        for i, layer in enumerate(self.layers):
            out, _ = layer(x, kv_lengths=kv_lengths, generator=generator)
            if self.training and self.layerdrop > 0.0:
                keep = torch.rand((), generator=generator, device=x.device) < 1.0 - self.layerdrop
                x = torch.where(keep, out, x)
            else:
                x = out
            if output_layer is not None and i + 1 == output_layer:
                return x
        if self.layer_norm_first:
            x = self.layer_norm(x)
        return x


class AVHuBERTEncoderWrapper(nn.Module):
    """Video-only fusion encoder: visual features (times the video's
    presence) -> ``layer_norm`` (``fuse_ln``) -> ``post_extract_proj`` ->
    ``dropout_input`` -> transformer. With ``use_audio=False`` and
    ``modality_fuse="add"`` the fused features are the visual features
    themselves (the JAX wrapper adds a zero audio stream). ``mask_emb`` is
    kept as a parameter; only span masking reads it."""

    def __init__(self, cfg: AVHuBERTConfig, device=None):
        super().__init__()
        if cfg.use_audio:
            raise _not_ported("the AV-HuBERT audio frontend (use_audio=True)", "item 9")
        if not cfg.use_visual:
            raise ValueError("a video-only AV-HuBERT needs use_visual=True")
        if cfg.modality_fuse != "add":
            raise _not_ported(f"modality_fuse={cfg.modality_fuse!r}", "item 9")
        self.cfg = cfg
        dtype, pdtype = _dtypes(cfg)
        self.feature_extractor_video = AVHuBERTVisualEncoder(cfg, device=device)
        self.layer_norm = LayerNormF32(cfg.hidden_size, device=device)
        self.post_extract_proj = CastLinear(cfg.hidden_size, cfg.hidden_size, device=device,
                                            param_dtype=pdtype, compute_dtype=dtype)
        self.mask_emb = nn.Parameter(torch.empty(cfg.hidden_size, device=device, dtype=pdtype))
        self.encoder = AVHuBERTTransformerEncoder(cfg, device=device)

    @torch.no_grad()
    def init_from(self, generator: torch.Generator) -> None:
        """``mask_emb`` from U[0, 1), as flax's ``uniform(1.0)``."""
        self.mask_emb.uniform_(0.0, 1.0, generator=generator)

    def _video_presence(self, batch: int, deterministic: bool,
                        generator: Optional[torch.Generator], device) -> Optional[torch.Tensor]:
        """The video half of ``_modality_presence`` (``avhubert.py:393-411``):
        in training with ``modality_dropout``, one draw drops one modality
        and a second picks the audio (``audio_dropout``) or the video, for
        the whole batch; [B] fp32 with the video's presence, None when
        nothing can be dropped."""
        cfg = self.cfg
        if deterministic or cfg.modality_dropout <= 0.0:
            return None
        drop_one = torch.rand((), generator=generator, device=device) < cfg.modality_dropout
        drop_audio = torch.rand((), generator=generator, device=device) < cfg.audio_dropout
        v = torch.where(drop_one & ~drop_audio, 0.0, 1.0).to(device)
        return v.expand(batch)

    def forward(
        self,
        audio: Optional[torch.Tensor] = None,
        video: Optional[torch.Tensor] = None,
        padding_mask: Optional[torch.Tensor] = None,
        audio_present: Optional[torch.Tensor] = None,
        video_present: Optional[torch.Tensor] = None,
        feature_mask: Optional[torch.Tensor] = None,
        channel_mask: Optional[torch.Tensor] = None,
        deterministic: Optional[bool] = None,
        use_running_average: Optional[bool] = None,
        output_layer: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``deterministic`` (None: not ``self.training``) must agree with
        the module's mode, which switches every dropout; BatchNorm uses the
        batch's statistics when ``use_running_average`` is False (None:
        ``deterministic``)."""
        if audio is not None:
            raise _not_ported("audio inputs to AV-HuBERT", "item 9")
        for name, value in (("audio_present", audio_present), ("video_present", video_present),
                            ("feature_mask", feature_mask), ("channel_mask", channel_mask)):
            if value is not None:
                raise _not_ported(name, "item 9")
        deterministic = _resolve_deterministic(self, deterministic)
        if use_running_average is None:
            use_running_average = deterministic
        if video is None:
            raise ValueError("At least one modality input is required")
        fused = self.feature_extractor_video(video, use_running_average)
        v_pres = self._video_presence(fused.shape[0], deterministic, generator, fused.device)
        if v_pres is not None:
            fused = fused * v_pres[:, None, None].to(fused.dtype)
        x = self.post_extract_proj(self.layer_norm(fused))
        x = residual_dropout(x, self.cfg.dropout_input, not deterministic, generator)
        if padding_mask is not None:
            padding_mask = padding_mask[:, : x.shape[1]]
        return self.encoder(x, padding_mask, output_layer=output_layer, generator=generator)


class AVHuBERTModel(AVHuBERTEncoderWrapper):
    """Encoder-only AV-HuBERT with ``extract_features``. fairseq keeps the
    wrapper's modules on the model, so this class is the wrapper plus the
    JAX model's entry points; train-time span masking raises."""

    def forward(self, audio=None, video=None, padding_mask=None, audio_present=None,
                video_present=None, apply_time_mask: bool = False,
                deterministic: Optional[bool] = None, use_running_average=None,
                feature_mask=None, channel_mask=None, output_layer=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if apply_time_mask and not _resolve_deterministic(self, deterministic):
            raise _not_ported("span masking (apply_time_mask)",
                              "item 12: models/pretrain.py")
        return super().forward(
            audio=audio, video=video, padding_mask=padding_mask, audio_present=audio_present,
            video_present=video_present, feature_mask=feature_mask, channel_mask=channel_mask,
            deterministic=deterministic, use_running_average=use_running_average,
            output_layer=output_layer, generator=generator,
        )

    def extract_features(self, audio=None, video=None, padding_mask=None, **kw) -> torch.Tensor:
        return self(audio=audio, video=video, padding_mask=padding_mask, deterministic=True, **kw)


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
