"""AV-HuBERT in PyTorch: the fusion encoder over 104-dim audio features and
lip video, the seq2seq decoder and the CTC head, with their losses.

Port of ``avsl_tpu/models/avhubert.py`` in inference and in training:
``Wav2Vec2FeatureEncoder`` (the optional raw-waveform conv stack, GroupNorm
in fp32 on its first layer) and ``AVHuBERTAudioEncoder`` (the projection
of stacked log-fbank features); ``AVHuBERTVisualEncoder`` (the ResNet
frontend and the projection), each frontend's gradient scaled by
``feature_grad_mult``; ``ConvPositionalEmbedding`` (the weight-normed
grouped positional conv); ``AVHuBERTTransformerEncoder`` (pre-norm blocks
whose self-attention runs the flash-attention kernel with per-row key
lengths; in training, dropout after ``pos_conv``, the blocks' dropouts and
LayerDrop); ``AVHuBERTEncoderWrapper`` with ``AVHuBERTModel`` (presence
flags, modality dropout, ``concat``/``add``/``weighted_sum`` fusion of the
two streams truncated to the shorter, ``fuse_ln`` over the fused width,
``post_extract_proj``, external feature and channel masks, input dropout);
``AVHuBERTForCTC`` with ``ctc_loss``; ``AVHuBERTDecoder`` (√d-scaled
embeddings, fairseq sinusoid or learned positions, the self-attention
through the flash-attention kernels as causal with key lengths, the
cross-attention onto a padded encoder output unfused and masked, decoder
LayerDrop, a final norm only when pre-norm, a tied or separate output
projection, fp32 logits) with ``AVHuBERTForSpeech2Text``; and
``cross_entropy_loss``.

Training follows the JAX modules' ``deterministic`` argument, here the
module's own mode (``model.train()``); random draws come from the
``generator`` the forward is given. BatchNorm uses the batch's statistics
(and updates the running ones) when ``use_running_average`` is False,
which it is by default in training. In training the attention dropout of
a block sends its self-attention down the unfused path, which ignores the
causal mask and the key lengths, as the JAX layer does
(``avsl_tpu/models/layers.py:301-310``). As in JAX, the decoder embeds in
the compute dtype and then, multiplied by the fp32 √d, carries an fp32
residual stream; each projection casts its input to the compute dtype.

State-dict names are fairseq AV-HuBERT's: the encoder's modules sit on
:class:`AVHuBERTModel` itself (``feature_extractor_{audio,video}``,
``layer_norm``, ``post_extract_proj``, ``mask_emb``, ``encoder.pos_conv.0``,
``encoder.layers.N.{self_attn, self_attn_layer_norm, fc1, fc2,
final_layer_norm}``, ``encoder.layer_norm``); the heads nest it under
``encoder.w2v_model.`` as fairseq's seq2seq checkpoints do, beside
``decoder.{embed_tokens, embed_positions, layers.N.{self_attn,
encoder_attn, ...}, layer_norm, output_projection}`` or ``ctc_head``. The
fixed sinusoid table is a buffer left out of the state dict.

With ``cfg.remat`` the ResNet frontend, each encoder block and each
decoder block of a full-sequence forward run under
:func:`~avsl_tpu_torch.models.layers.remat_block` with
``cfg.remat_policy``, where JAX remats them (``avhubert.py:197-203``,
``:298-305``, ``:678-683``).

Span masks (:func:`span_mask`, the static-shape draw of fairseq's
``compute_mask_indices``) are drawn in training by ``AVHuBERTModel`` with
``apply_time_mask``, and by the pretraining head
(:mod:`avsl_tpu_torch.models.pretrain`). With ``cfg.n_experts > 0`` every
encoder block's MLP is the MoE FFN of :mod:`avsl_tpu_torch.models.moe`. The
wrapper sows its fused features before ``layer_norm`` as
``"extracted_features"`` (the pretraining feature penalty reads them;
:mod:`avsl_tpu_torch.models.intermediates`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avsl_tpu_torch.core.config import AVHuBERTConfig
from avsl_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    constrain_activation,
    copy_to_group,
    draw_rows,
    gather_from_group,
    reduce_from_group,
)
from avsl_tpu_torch.models.intermediates import sow
from avsl_tpu_torch.models.layers import (
    Cache,
    CastConv1d,
    CastLinear,
    LayerNormF32,
    TransformerBlock,
    cast_param,
    check_remat_policy,
    fairseq_sinusoid_embedding,
    grad_multiply,
    init_self_attn_cache,
    positions,
    remat_block,
    residual_dropout,
    torch_dtype,
)
from avsl_tpu_torch.models.resnet3d import ResNet3DFrontend
from avsl_tpu_torch.utils.spans import count


def span_mask_from_uniform(
    u: torch.Tensor,
    mask_prob: float,
    mask_length: int,
    padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The span mask [B, T] (True = masked) that JAX's ``span_mask``
    (``avhubert.py:46-99``) makes from its uniforms ``u`` [B, T]: a
    deterministic function of ``u``, so JAX's own draw gives JAX's mask.

    ``num_spans = round(mask_prob * T / mask_length)`` clamped to [1, T]
    starts are the first ``num_spans`` of a stable argsort of ``u`` with
    the positions at or past ``hi = max(sz - mask_length, 1)`` set to inf
    (``sz`` each row's unpadded length), i.e. distinct starts drawn
    uniformly without replacement from [0, hi); a row keeps its first
    ``round(mask_prob * sz / mask_length)`` (at least 1) spans whose start
    is finite; each masks ``mask_length`` steps; the result is ANDed with
    ``padding_mask`` (True = a real step)."""
    batch, length = u.shape
    if mask_prob <= 0.0 or length == 0:
        return torch.zeros((batch, length), dtype=torch.bool, device=u.device)
    num_spans = min(max(1, int(mask_prob * length / float(mask_length) + 0.5)), length)
    if padding_mask is not None:
        padding_mask = padding_mask.to(u.device).bool()
        sz = padding_mask.sum(dim=1, dtype=torch.int32)
    else:
        sz = torch.full((batch,), length, dtype=torch.int32, device=u.device)
    hi = (sz - mask_length).clamp_min(1)
    num_i = (mask_prob * sz.float() / mask_length + 0.5).to(torch.int32).clamp_min(1)
    pos1 = torch.arange(length, device=u.device)[None, :]
    u = torch.where(pos1 < hi[:, None], u.float(), torch.full((), math.inf, device=u.device))
    starts = torch.argsort(u, dim=1, stable=True)[:, :num_spans]
    span_ids = torch.arange(num_spans, device=u.device)[None, :]
    valid = (u.gather(1, starts) < math.inf) & (span_ids < num_i[:, None])
    pos = torch.arange(length, device=u.device)[None, None, :]
    spans = ((pos >= starts[..., None]) & (pos < starts[..., None] + mask_length)
             & valid[..., None])
    mask = spans.any(dim=1)
    if padding_mask is not None:
        mask = mask & padding_mask
    return mask


def span_mask(
    generator: Optional[torch.Generator],
    batch: int,
    length: int,
    mask_prob: float,
    mask_length: int,
    padding_mask: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """A random span mask [B, T] (True = masked): ``u`` uniform [B, T] from
    ``generator`` on ``device`` (``padding_mask``'s when None), then
    :func:`span_mask_from_uniform`."""
    if mask_prob <= 0.0 or length == 0:
        return torch.zeros((batch, length), dtype=torch.bool, device=device)
    if generator is None:
        raise ValueError("a span mask needs an explicit torch.Generator")
    if device is None and padding_mask is not None:
        device = padding_mask.device
    u = draw_rows(lambda s: torch.rand(s, generator=generator, device=device), (batch, length))
    return span_mask_from_uniform(u, mask_prob, mask_length, padding_mask)


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
        self.remat, self.remat_policy = bool(cfg.remat), check_remat_policy(cfg.remat_policy)
        self.resnet = ResNet3DFrontend(
            cfg.visual_frontend_channels, cfg.visual_backbone_channels, cfg.resnet_relu_type,
            dtype=dtype, param_dtype=pdtype, device=device,
        )
        self.proj = CastLinear(cfg.visual_backbone_channels, cfg.hidden_size, device=device,
                               param_dtype=pdtype, compute_dtype=dtype)

    def forward(self, video: torch.Tensor, use_running_average: bool = True) -> torch.Tensor:
        if self.remat:
            feats = remat_block(self.resnet, self.remat_policy, (), video, use_running_average)
        else:
            feats = self.resnet(video, use_running_average)
        if self.feature_grad_mult != 1.0:
            feats = grad_multiply(feats, self.feature_grad_mult)
        return self.proj(feats)


class Wav2Vec2FeatureEncoder(nn.Module):
    """Temporal conv stack over the raw waveform (wav2vec2's): [B, n] ->
    [B, T', conv_dim[-1]]. Valid convolutions without bias (``conv_i``),
    a GroupNorm with a group per channel in fp32 after the first
    (``group_norm``, eps 1e-6 as flax's), exact GELU after each."""

    def __init__(self, cfg: AVHuBERTConfig, device=None):
        super().__init__()
        dtype, pdtype = _dtypes(cfg)
        self.dtype, self.n_layers = dtype, len(cfg.conv_dim)
        in_ch = 1
        for i, (dim, kernel, stride) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel,
                                                      cfg.conv_stride)):
            self.add_module(f"conv_{i}", CastConv1d(in_ch, dim, kernel, stride=stride, bias=False,
                                                    device=device, param_dtype=pdtype,
                                                    compute_dtype=dtype))
            in_ch = dim
        self.group_norm = nn.GroupNorm(cfg.conv_dim[0], cfg.conv_dim[0], eps=1e-6, device=device,
                                       dtype=torch.float32)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        x = audio.to(self.dtype)[:, None, :]
        for i in range(self.n_layers):
            x = self._modules[f"conv_{i}"](x)
            if i == 0:
                x = self.group_norm(x.float()).to(self.dtype)
            x = F.gelu(x)
        return x.transpose(1, 2)

    @staticmethod
    def output_length(cfg: AVHuBERTConfig, n_samples: int) -> int:
        """Frames out of ``n_samples`` through the valid strided convs."""
        t = n_samples
        for kernel, stride in zip(cfg.conv_kernel, cfg.conv_stride):
            t = (t - kernel) // stride + 1
        return t


class AVHuBERTAudioEncoder(nn.Module):
    """Audio frontend -> hidden_size features, fairseq's
    ``feature_extractor_audio``: the 104-dim stacked log-fbank frames (25 Hz,
    aligned with 25 fps video) through ``proj``, or with
    ``use_conv_audio_frontend`` the raw waveform through
    :class:`Wav2Vec2FeatureEncoder` first; the features' gradient is scaled
    by ``feature_grad_mult``."""

    def __init__(self, cfg: AVHuBERTConfig, device=None):
        super().__init__()
        dtype, pdtype = _dtypes(cfg)
        self.dtype, self.feature_grad_mult = dtype, cfg.feature_grad_mult
        in_dim = cfg.audio_feat_dim
        if cfg.use_conv_audio_frontend:
            self.conv_frontend = Wav2Vec2FeatureEncoder(cfg, device=device)
            in_dim = cfg.conv_dim[-1]
        self.proj = CastLinear(in_dim, cfg.hidden_size, device=device, param_dtype=pdtype,
                               compute_dtype=dtype)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        frontend = self._modules.get("conv_frontend")
        feats = frontend(audio) if frontend is not None else audio.to(self.dtype)
        if self.feature_grad_mult != 1.0:
            feats = grad_multiply(feats, self.feature_grad_mult)
        return self.proj(feats)


class _GroupedConv1d(torch.autograd.Function):
    """``F.conv1d(x, w, b, padding=padding, groups=groups)`` with a bias, at
    stride and dilation 1 and a padding under the taps, whose input
    gradient runs as a forward convolution: a stride-1 conv's data gradient
    is the conv of ``dy`` with the kernel regrouped to [in, out/groups, k]
    and flipped along the taps, at padding ``k - 1 - padding``. At AV-HuBERT
    large's shape (1024 channels, 128 taps, 16 groups) cuDNN's backward-data
    engine runs about 70 times slower than its forward, and rounds further
    from the fp32 gradient. The weight and bias gradients are
    ``convolution_backward`` with the input's left out of the mask. Each
    input gradient adds one to the counter ``avhubert.pos_conv_input_grad``."""

    @staticmethod
    def forward(ctx, x, w, b, padding: int, groups: int):
        ctx.save_for_backward(x, w)
        ctx.padding, ctx.groups = padding, groups
        return F.conv1d(x, w, b, padding=padding, groups=groups)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        p, g = ctx.padding, ctx.groups
        co, ci_g, k = w.shape
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            count("avhubert.pos_conv_input_grad", 1)
            w_t = (w.view(g, co // g, ci_g, k).transpose(1, 2).reshape(g * ci_g, co // g, k)
                   .flip(-1))
            if dy.is_cpu and dy.dtype == torch.bfloat16:
                # oneDNN's bf16 conv on the CPU is wrong at some shapes with
                # few channels a group and 8 taps or more
                dx = F.conv1d(dy.float(), w_t.float(), padding=k - 1 - p, groups=g).to(dy.dtype)
            else:
                dx = F.conv1d(dy, w_t, padding=k - 1 - p, groups=g)
        mask = [False, ctx.needs_input_grad[1], ctx.needs_input_grad[2]]
        if mask[1] or mask[2]:
            _, dw, db = torch.ops.aten.convolution_backward(dy, x, w, [co], [1], [p], [1], False,
                                                            [0], g, mask)
        return dx, dw, db, None, None


class WeightNormConv1d(nn.Module):
    """Grouped Conv1d under flax ``nn.WeightNorm``'s parametrisation: the
    kernel is ``weight_g * weight_v / ||weight_v||`` with the norm taken per
    output channel (over input channels and taps; torch
    ``weight_norm(dim=0)``). ``weight_g`` [out, 1, 1] and ``weight_v`` [out,
    in/groups, k] are fp32 and the kernel is computed in fp32, then cast
    once to the compute dtype; the bias lives in ``param_dtype``. Under
    autograd the conv is :class:`_GroupedConv1d`."""

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
        w, b = self.kernel().to(self.dtype), cast_param(self.bias, self.dtype)
        if torch.is_grad_enabled():
            return _GroupedConv1d.apply(x, w, b, self.padding, self.groups)
        return F.conv1d(x, w, b, padding=self.padding, groups=self.groups)


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


def _layerdrop(out: torch.Tensor, x: torch.Tensor, rate: float,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """LayerDrop: one draw for the whole batch keeps the layer's output or
    its input, chosen by ``torch.where`` on the device (no host sync)."""
    keep = torch.rand((), generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, out, x)


class AVHuBERTTransformerEncoder(nn.Module):
    """Pre-norm (``layer_norm_first``) transformer encoder with padding
    zeroing, fairseq's ``encoder``: padded steps (``padding_mask`` False)
    are zeroed before ``pos_conv``, the self-attention masks keys past each
    row's valid length (the kernel's ``lengths``), and ``layer_norm`` runs
    after the stack (before it when not ``layer_norm_first``). In training
    (``model.train()``): dropout at ``hidden_dropout`` after the positional
    conv, the blocks' own dropouts, and LayerDrop: one draw a layer a
    forward, shared by the batch, keeping the layer's output or its input
    with ``torch.where`` on the device (no host sync). The block runs
    before that choice, so a dropped MoE layer still sows its balance
    loss, as in JAX."""

    def __init__(self, cfg: AVHuBERTConfig, device=None):
        super().__init__()
        dtype, pdtype = _dtypes(cfg)
        self.layer_norm_first = cfg.layer_norm_first
        self.hidden_dropout, self.layerdrop = cfg.hidden_dropout, cfg.layerdrop
        self.remat, self.remat_policy = bool(cfg.remat), check_remat_policy(cfg.remat_policy)
        self.pos_conv = ConvPositionalEmbedding(cfg, device=device)
        self.layers = nn.ModuleList(
            TransformerBlock(
                cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
                pre_norm=cfg.layer_norm_first, use_k_bias=True, names="fairseq",
                dtype=dtype, param_dtype=pdtype, device=device, dropout=cfg.hidden_dropout,
                attention_dropout=cfg.attention_dropout,
                activation_dropout=cfg.activation_dropout, n_experts=cfg.n_experts,
                moe_top_k=cfg.moe_top_k, moe_capacity_factor=cfg.moe_capacity_factor,
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
        # sequence parallelism between blocks (see models/whisper.py); the
        # key lengths stay global, as attention sees the whole sequence
        x, split = constrain_activation(x, DATA_AXIS, MODEL_AXIS, None)
        for i, layer in enumerate(self.layers):
            if self.remat:
                out, _ = remat_block(layer, self.remat_policy, (generator,), x,
                                     kv_lengths=kv_lengths, generator=generator, seq_split=split)
            else:
                out, _ = layer(x, kv_lengths=kv_lengths, generator=generator, seq_split=split)
            if self.training and self.layerdrop > 0.0:
                x = _layerdrop(out, x, self.layerdrop, generator)
            else:
                x = out
            if output_layer is not None and i + 1 == output_layer:
                return x if split is None else split.gather(x)
        if split is not None:
            x = split.gather(x)
        if self.layer_norm_first:
            x = self.layer_norm(x)
        return x


def _scaled(feats: torch.Tensor, presence: Optional[torch.Tensor]) -> torch.Tensor:
    """``feats`` [B, T, C] times a [B] presence (None: all present)."""
    if presence is None:
        return feats
    return feats * presence[:, None, None].to(feats.dtype)


class AVHuBERTEncoderWrapper(nn.Module):
    """Fusion encoder over the audio and visual streams: each frontend's
    features times the stream's presence, fused (``concat``, ``add`` or a
    learned ``weighted_sum``) over the frames both streams have, then
    ``layer_norm`` (``fuse_ln``, over ``encoder_hidden_size``) ->
    ``post_extract_proj`` -> feature and channel masks -> ``dropout_input``
    -> transformer. A missing stream is zeros, as in JAX (with ``add`` the
    present stream's features pass as they are)."""

    def __init__(self, cfg: AVHuBERTConfig, device=None):
        super().__init__()
        if not (cfg.use_audio or cfg.use_visual):
            raise ValueError("AV-HuBERT needs use_audio or use_visual")
        if cfg.modality_fuse not in ("concat", "add", "weighted_sum"):
            raise ValueError(f"Unknown modality_fuse {cfg.modality_fuse!r}")
        self.cfg = cfg
        dtype, pdtype = _dtypes(cfg)
        if cfg.use_audio:
            self.feature_extractor_audio = AVHuBERTAudioEncoder(cfg, device=device)
        if cfg.use_visual:
            self.feature_extractor_video = AVHuBERTVisualEncoder(cfg, device=device)
        if cfg.modality_fuse == "weighted_sum":
            self.fusion_logits = nn.Parameter(torch.empty(2, device=device, dtype=pdtype))
        self.layer_norm = LayerNormF32(cfg.encoder_hidden_size, device=device)
        self.post_extract_proj = CastLinear(cfg.encoder_hidden_size, cfg.hidden_size,
                                            device=device, param_dtype=pdtype, compute_dtype=dtype)
        self.mask_emb = nn.Parameter(torch.empty(cfg.hidden_size, device=device, dtype=pdtype))
        self.encoder = AVHuBERTTransformerEncoder(cfg, device=device)

    @torch.no_grad()
    def init_from(self, generator: torch.Generator) -> None:
        """``mask_emb`` from U[0, 1), as flax's ``uniform(1.0)``; zero
        ``fusion_logits`` (equal weights)."""
        self.mask_emb.uniform_(0.0, 1.0, generator=generator)
        if self.cfg.modality_fuse == "weighted_sum":
            self.fusion_logits.zero_()

    def _modality_presence(
        self, batch: int, audio_present: Optional[torch.Tensor],
        video_present: Optional[torch.Tensor], deterministic: bool,
        generator: Optional[torch.Generator], device,
    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """``_modality_presence`` (``avhubert.py:393-411``): the [B] fp32
        presence of each stream (None: present everywhere). In training
        with ``modality_dropout``, one draw drops one stream and a second
        picks the audio (``audio_dropout``) or the video, for the whole
        batch."""
        cfg = self.cfg
        a = None if audio_present is None else audio_present.to(device, torch.float32)
        v = None if video_present is None else video_present.to(device, torch.float32)
        if deterministic or cfg.modality_dropout <= 0.0:
            return a, v
        drop_one = torch.rand((), generator=generator, device=device) < cfg.modality_dropout
        drop_audio = torch.rand((), generator=generator, device=device) < cfg.audio_dropout
        keep_a = torch.where(drop_one & drop_audio, 0.0, 1.0).to(device)
        keep_v = torch.where(drop_one & ~drop_audio, 0.0, 1.0).to(device)
        a = keep_a.expand(batch) if a is None else a * keep_a
        v = keep_v.expand(batch) if v is None else v * keep_v
        return a, v

    def _fuse(self, feat_a: Optional[torch.Tensor], feat_v: Optional[torch.Tensor]) -> torch.Tensor:
        """The streams truncated to the shorter one (the reference's
        audio/video alignment) and fused; a missing one is zeros."""
        fuse = self.cfg.modality_fuse
        if feat_a is None or feat_v is None:
            present = feat_a if feat_a is not None else feat_v
            if fuse == "add":
                return present
            zeros = torch.zeros_like(present)
            feat_a, feat_v = (present, zeros) if feat_a is not None else (zeros, present)
        t = min(feat_a.shape[1], feat_v.shape[1])
        feat_a, feat_v = feat_a[:, :t], feat_v[:, :t]
        if fuse == "concat":
            return torch.cat([feat_a, feat_v], dim=-1)
        if fuse == "add":
            return feat_a + feat_v
        w = torch.softmax(self.fusion_logits.float(), dim=0)
        return (w[0] * feat_a.float() + w[1] * feat_v.float()).to(feat_a.dtype)

    def forward(
        self,
        audio: Optional[torch.Tensor] = None,
        video: Optional[torch.Tensor] = None,
        padding_mask: Optional[torch.Tensor] = None,
        audio_present: Optional[torch.Tensor] = None,
        video_present: Optional[torch.Tensor] = None,
        feature_mask: Optional[torch.Tensor] = None,  # [B, T] True = replace with mask_emb
        channel_mask: Optional[torch.Tensor] = None,  # [B, C] True = zero the channel
        deterministic: Optional[bool] = None,
        use_running_average: Optional[bool] = None,
        output_layer: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``deterministic`` (None: not ``self.training``) must agree with
        the module's mode, which switches every dropout; BatchNorm uses the
        batch's statistics when ``use_running_average`` is False (None:
        ``deterministic``). ``audio``: [B, T, audio_feat_dim] features (the
        raw wave [B, n] with ``use_conv_audio_frontend``); ``video``: [B, T,
        H, W, 1] lip clips; ``*_present``: [B] flags."""
        cfg = self.cfg
        deterministic = _resolve_deterministic(self, deterministic)
        if use_running_average is None:
            use_running_average = deterministic
        src = audio if audio is not None else video
        if src is None:
            raise ValueError("At least one modality input is required")
        a_pres, v_pres = self._modality_presence(src.shape[0], audio_present, video_present,
                                                 deterministic, generator, src.device)
        feat_a = feat_v = None
        if cfg.use_audio and audio is not None:
            feat_a = _scaled(self.feature_extractor_audio(audio), a_pres)
        if cfg.use_visual and video is not None:
            feat_v = _scaled(self.feature_extractor_video(video, use_running_average), v_pres)
        if feat_a is None and feat_v is None:
            raise ValueError("At least one modality input is required")
        fused = self._fuse(feat_a, feat_v)
        sow("extracted_features", fused)  # the pretraining feature penalty's input
        x = self.post_extract_proj(self.layer_norm(fused))
        t = x.shape[1]
        if feature_mask is not None:
            x = torch.where(feature_mask[:, :t, None].to(x.device), self.mask_emb.to(x.dtype), x)
        if channel_mask is not None:
            x = torch.where(channel_mask[:, None, :].to(x.device), torch.zeros((), dtype=x.dtype,
                                                                               device=x.device), x)
        x = residual_dropout(x, cfg.dropout_input, not deterministic, generator)
        if padding_mask is not None:
            padding_mask = padding_mask[:, :t]
        return self.encoder(x, padding_mask, output_layer=output_layer, generator=generator)


class AVHuBERTModel(AVHuBERTEncoderWrapper):
    """Encoder-only AV-HuBERT with ``extract_features``. fairseq keeps the
    wrapper's modules on the model, so this class is the wrapper plus the
    JAX model's entry points and its train-time span masking."""

    def forward(self, audio=None, video=None, padding_mask=None, audio_present=None,
                video_present=None, apply_time_mask: bool = False,
                deterministic: Optional[bool] = None, use_running_average=None,
                feature_mask=None, channel_mask=None, output_layer=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """With ``apply_time_mask`` in training and no mask given (masks the
        caller passes take precedence), a time span mask is drawn from
        ``generator`` at the audio rates (``mask_prob_audio``,
        ``mask_length_audio``) when audio is given, else the image rates,
        over the conv stack's output length for a raw waveform; and with
        ``mask_feature_prob > 0`` a channel span mask over ``hidden_size``
        (``avhubert.py:519-572``)."""
        if (apply_time_mask and feature_mask is None and channel_mask is None
                and not _resolve_deterministic(self, deterministic)):
            cfg = self.cfg
            src = audio if audio is not None else video
            t = src.shape[1]
            if audio is not None and cfg.use_conv_audio_frontend and audio.ndim == 2:
                t = Wav2Vec2FeatureEncoder.output_length(cfg, t)
            prob, span = ((cfg.mask_prob_audio, cfg.mask_length_audio) if audio is not None
                          else (cfg.mask_prob_image, cfg.mask_length_image))
            feature_mask = span_mask(generator, src.shape[0], t, prob, span, padding_mask,
                                     device=src.device)
            if cfg.mask_feature_prob > 0.0:
                channel_mask = span_mask(generator, src.shape[0], cfg.hidden_size,
                                         cfg.mask_feature_prob, cfg.mask_feature_length,
                                         device=src.device)
        return super().forward(
            audio=audio, video=video, padding_mask=padding_mask, audio_present=audio_present,
            video_present=video_present, feature_mask=feature_mask, channel_mask=channel_mask,
            deterministic=deterministic, use_running_average=use_running_average,
            output_layer=output_layer, generator=generator,
        )

    def extract_features(self, audio=None, video=None, padding_mask=None, **kw) -> torch.Tensor:
        return self(audio=audio, video=video, padding_mask=padding_mask, deterministic=True, **kw)


def _nested_encoder(cfg: AVHuBERTConfig, device) -> nn.ModuleDict:
    """The encoder under fairseq's seq2seq nesting ``encoder.w2v_model.``."""
    return nn.ModuleDict({"w2v_model": AVHuBERTModel(cfg, device=device)})


class AVHuBERTForCTC(nn.Module):
    """Encoder + dropout (``hidden_dropout``) + linear CTC head (``ctc_head``);
    fp32 logits [B, T, vocab]. The CTC loss is :func:`ctc_loss` (blank =
    pad id)."""

    def __init__(self, cfg: AVHuBERTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype, pdtype = _dtypes(cfg)
        self.encoder = _nested_encoder(cfg, device)
        self.ctc_head = CastLinear(cfg.hidden_size, cfg.vocab_size, device=device,
                                   param_dtype=pdtype, compute_dtype=dtype)

    @property
    def avhubert(self) -> AVHuBERTModel:
        return self.encoder["w2v_model"]

    def forward(self, audio=None, video=None, padding_mask=None,
                deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None, **kw) -> torch.Tensor:
        h = self.avhubert(audio=audio, video=video, padding_mask=padding_mask,
                          deterministic=deterministic, generator=generator, **kw)
        h = residual_dropout(h, self.cfg.hidden_dropout, self.training, generator)
        return self.ctc_head(h).float()


def optax_ctc_loss(
    logits: torch.Tensor,
    logit_padding: torch.Tensor,
    labels: torch.Tensor,
    label_padding: torch.Tensor,
    blank_id: int = 0,
    log_epsilon: float = -1e5,
) -> torch.Tensor:
    """Per-sequence CTC loss [B], the recursion of ``optax.ctc_loss`` in
    fp32 torch ops: a loop over frames on the blank-state scores [B, N+1]
    and the label-state scores [B, N], ``log_epsilon`` standing for
    log(0). Padding arguments are 1.0 at PAD (labels right-padded); a
    padded frame carries the scores over. A row whose labels cannot fit
    in its frames gets a large finite loss (about -log_epsilon), not inf
    (``torch.nn.functional.ctc_loss`` returns inf there)."""
    b, n = labels.shape
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    label_padding = label_padding.float()
    labellens = n - label_padding.sum(dim=1).to(torch.int64)
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))  # [B, N]
    lp_phi = logprobs[:, :, blank_id]  # [B, T]
    # a padded label (e.g. -100) reads class 0: no state before labellens
    # depends on a padded label's emission score
    gather_ids = labels.long().clamp(min=0)[:, None, :].expand(-1, logprobs.shape[1], -1)
    lp_emit = torch.gather(logprobs, 2, gather_ids)  # [B, T, N]
    pads = logit_padding.float()

    def update_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=-1)

    phi = torch.full((b, n + 1), log_epsilon, device=logits.device)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), log_epsilon, device=logits.device)
    for t in range(logits.shape[1]):
        prev_phi = phi
        phi_eps = update_phi(phi, emit + log_epsilon * repeat)
        next_emit = torch.logaddexp(phi_eps[:, :-1] + lp_emit[:, t], emit + lp_emit[:, t])
        next_phi = phi_eps + lp_phi[:, t:t + 1]
        next_phi = update_phi(next_phi, emit + lp_phi[:, t:t + 1] + log_epsilon * (1.0 - repeat))
        pad = pads[:, t:t + 1]
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi + (1.0 - pad) * next_phi
    phi_last = update_phi(phi, emit)
    return -torch.gather(phi_last, 1, labellens[:, None])[:, 0]


def ctc_loss(
    logits: torch.Tensor,
    logit_padding: torch.Tensor,
    labels: torch.Tensor,
    label_padding: torch.Tensor,
    blank_id: int = 1,
) -> torch.Tensor:
    """Mean CTC loss; padding arguments are 1 at PAD (optax's convention).
    Rows with no labels, or a non-finite loss, contribute 0 (the zero-length
    guard); the mean is over every row."""
    per_seq = optax_ctc_loss(logits, logit_padding, labels, label_padding, blank_id=blank_id)
    has_labels = (1.0 - label_padding.float()).sum(dim=-1) > 0
    per_seq = torch.where(has_labels & torch.isfinite(per_seq), per_seq,
                          torch.zeros((), device=per_seq.device))
    return per_seq.mean()


class AVHuBERTDecoder(nn.Module):
    """Transformer decoder with √d-scaled embeddings, fairseq sinusoid or
    learned positions, a KV cache, and a tied or separate output
    projection; fairseq's ``decoder``.

    In full mode the self-attention runs causal with the key lengths of the
    tokens that are not pad (the flash-attention kernels; the collators pad
    at the end), and the cross-attention takes ``encoder_padding`` as a
    mask (unfused). In training: dropout on the scaled, positioned
    embeddings, the blocks' dropouts and decoder LayerDrop (full mode only),
    one device draw a layer a forward, computed in every layer.

    With a vocab-sharded ``embed_tokens`` (:meth:`set_vocab_parallel`) each
    model rank holds its rows of the vocabulary: the lookup embeds the ids
    in its rows and sums over the group, and the tied logits of each
    rank's rows are all-gathered over the vocabulary, as
    ``WhisperTextDecoder`` does."""

    def __init__(self, cfg: AVHuBERTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype, pdtype = _dtypes(cfg)
        self.compute_dtype = dtype
        self.vocab_tp: Optional[Tuple[object, int, int]] = None
        self.remat_policy = check_remat_policy(cfg.remat_policy)
        d = cfg.decoder_hidden_size
        self.embed_tokens = nn.Embedding(cfg.vocab_size, d, device=device, dtype=pdtype)
        if cfg.decoder_learned_pos:
            self.embed_positions = nn.Embedding(cfg.max_target_positions, d, device=device,
                                                dtype=pdtype)
        else:  # fixed table, recomputed, not in the state dict
            self.register_buffer("sinusoid_positions", torch.empty(
                (cfg.max_target_positions, d), device=device, dtype=torch.float32),
                persistent=False)
        self.layers = nn.ModuleList(
            TransformerBlock(
                d, cfg.decoder_attention_heads, cfg.decoder_ffn_dim, has_cross_attn=True,
                causal_self_attn=True, pre_norm=cfg.decoder_normalize_before,
                dropout=cfg.decoder_dropout, attention_dropout=cfg.decoder_attention_dropout,
                activation_dropout=cfg.decoder_activation_dropout, use_k_bias=True,
                names="fairseq", dtype=dtype, param_dtype=pdtype, device=device,
                cross_kv_dim=cfg.hidden_size,
            )
            for _ in range(cfg.decoder_layers)
        )
        if cfg.decoder_normalize_before:
            self.layer_norm = LayerNormF32(d, device=device)
        if not cfg.tie_word_embeddings:
            self.output_projection = CastLinear(d, cfg.vocab_size, bias=False, device=device,
                                                param_dtype=pdtype, compute_dtype=dtype)

    @torch.no_grad()
    def init_from(self, generator: torch.Generator) -> None:
        """Learned positions from N(0, 0.02) (flax's), or the sinusoid table."""
        if self.cfg.decoder_learned_pos:
            self.embed_positions.weight.normal_(0.0, 0.02, generator=generator)
        else:
            self.reset_sinusoid_positions()

    def set_vocab_parallel(self, group, rank: int, size: int) -> None:
        """Run as part ``rank`` of ``size`` of a vocab-sharded embedding over
        ``group``; ``core/partitioning.py::shard_state`` cuts the rows."""
        self.vocab_tp = (group, rank, size)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.vocab_tp is None:
            return self.embed_tokens(tokens)
        group, rank, _ = self.vocab_tp
        rows = self.embed_tokens.weight.shape[0]
        local = tokens - rank * rows
        outside = (local < 0) | (local >= rows)
        emb = F.embedding(local.clamp(0, rows - 1), self.embed_tokens.weight)
        emb = torch.where(outside[..., None], torch.zeros((), dtype=emb.dtype, device=emb.device),
                          emb)
        return reduce_from_group(emb, group)

    def reset_sinusoid_positions(self) -> None:
        table = fairseq_sinusoid_embedding(*self.sinusoid_positions.shape, self.cfg.pad_token_id)
        with torch.no_grad():
            self.sinusoid_positions.copy_(torch.from_numpy(table))

    def _positions(self) -> torch.Tensor:
        if self.cfg.decoder_learned_pos:
            return self.embed_positions.weight
        return self.sinusoid_positions

    def forward(
        self,
        tokens: torch.Tensor,
        encoder_out: Optional[torch.Tensor] = None,
        encoder_padding: Optional[torch.Tensor] = None,  # [B, S] True = valid
        cache: Optional[List[Cache]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Optional[List[Cache]]]:
        cfg = self.cfg
        qlen = tokens.shape[1]
        emb = self._embed(tokens).to(self.compute_dtype)
        # the compute-dtype embedding times the fp32 sqrt(d): an fp32 stream
        x = emb.float() * np.float32(math.sqrt(cfg.decoder_hidden_size))
        x = x + positions(self._positions(), cache, qlen).to(x.dtype)
        x = residual_dropout(x, cfg.decoder_dropout, self.training, generator)

        dec_lengths = None
        if cache is None:
            dec_lengths = (tokens != cfg.pad_token_id).sum(dim=-1, dtype=torch.int32)
        enc_mask = None
        if encoder_padding is not None:
            enc_mask = encoder_padding[:, None, None, :].to(x.device)

        new_cache: Optional[List[Cache]] = [] if cache is not None else None
        for i, layer in enumerate(self.layers):
            if cfg.remat and cache is None:
                out, c = remat_block(layer, self.remat_policy, (generator,), x, enc=encoder_out,
                                     generator=generator, kv_lengths=dec_lengths,
                                     enc_mask=enc_mask)
            else:
                out, c = layer(x, enc=encoder_out, cache=None if cache is None else cache[i],
                               generator=generator, kv_lengths=dec_lengths, enc_mask=enc_mask)
            if cfg.decoder_layerdrop > 0.0 and self.training and cache is None:
                x = _layerdrop(out, x, cfg.decoder_layerdrop, generator)
            else:
                x = out
            if new_cache is not None:
                new_cache.append(c)
        if cfg.decoder_normalize_before:
            x = self.layer_norm(x)
        if cfg.tie_word_embeddings and self.vocab_tp is not None:
            group = self.vocab_tp[0]
            logits = gather_from_group(
                F.linear(copy_to_group(x.float(), group), self.embed_tokens.weight.float()),
                group, -1)
        elif cfg.tie_word_embeddings:
            # fp32 products of x and the stored embedding, as the JAX einsum
            logits = F.linear(x.float(), self.embed_tokens.weight.float())
        else:
            logits = self.output_projection(x)
        return logits.float(), new_cache


class AVHuBERTForSpeech2Text(nn.Module):
    """Encoder + decoder seq2seq model: ``shift_right`` teacher forcing,
    ``encode``, ``decode``, ``init_decode_cache`` and a forward that returns
    ``{"logits", "encoder_out"}`` (and ``"loss"``, the label-smoothed
    cross-entropy, with ``labels``)."""

    def __init__(self, cfg: AVHuBERTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = _nested_encoder(cfg, device)
        self.decoder = AVHuBERTDecoder(cfg, device=device)

    @property
    def avhubert(self) -> AVHuBERTModel:
        return self.encoder["w2v_model"]

    def shift_right(self, labels: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        shifted = torch.roll(labels, 1, dims=-1)
        shifted[:, 0] = cfg.bos_token_id if cfg.bos_token_id is not None else cfg.eos_token_id
        return torch.where(shifted == -100, torch.full_like(shifted, cfg.pad_token_id), shifted)

    def encode(self, audio=None, video=None, padding_mask=None,
               deterministic: Optional[bool] = None,
               generator: Optional[torch.Generator] = None, **kw) -> torch.Tensor:
        return self.avhubert(audio=audio, video=video, padding_mask=padding_mask,
                             deterministic=deterministic, generator=generator, **kw)

    def decode(self, tokens: torch.Tensor, encoder_out: Optional[torch.Tensor],
               encoder_padding: Optional[torch.Tensor] = None,
               cache: Optional[List[Cache]] = None,
               generator: Optional[torch.Generator] = None,
               ) -> Tuple[torch.Tensor, Optional[List[Cache]]]:
        return self.decoder(tokens, encoder_out, encoder_padding, cache, generator)

    def init_decode_cache(self, encoder_out: torch.Tensor, max_len: int) -> List[Cache]:
        """Zeroed self-attention buffers and the cross-attention K/V of
        ``encoder_out``, one entry per decoder layer."""
        cfg = self.cfg
        head_dim = cfg.decoder_hidden_size // cfg.decoder_attention_heads
        return [{"self": init_self_attn_cache(encoder_out.shape[0], max_len,
                                              cfg.decoder_attention_heads, head_dim,
                                              torch_dtype(cfg.dtype), encoder_out.device),
                 "cross": layer.cross.precompute_kv(encoder_out)}
                for layer in self.decoder.layers]

    def forward(self, audio=None, video=None, labels=None, decoder_input_ids=None,
                padding_mask=None, deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None, **kw) -> Dict[str, Any]:
        encoder_out = self.encode(audio=audio, video=video, padding_mask=padding_mask,
                                  deterministic=deterministic, generator=generator, **kw)
        if decoder_input_ids is None:
            if labels is None:
                raise ValueError("Need labels or decoder_input_ids")
            decoder_input_ids = self.shift_right(labels)
        encoder_padding = None
        if padding_mask is not None:
            encoder_padding = padding_mask[:, : encoder_out.shape[1]]
        logits, _ = self.decode(decoder_input_ids, encoder_out, encoder_padding,
                                generator=generator)
        out = {"logits": logits, "encoder_out": encoder_out}
        if labels is not None:
            out["loss"] = cross_entropy_loss(logits, labels,
                                             label_smoothing=self.cfg.label_smoothing)
        return out


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn from ``generator`` on the model's device:
    fan-in-scaled normal weights, zero biases, unit norm scales,
    1/sqrt(d)-scaled normal embeddings, and each module's own
    initialisation (``init_from``: BatchNorm identity statistics, PReLU
    slopes 0.25, unit weight-norm scales, ``mask_emb`` from U[0, 1), zero
    fusion logits, the decoder's positions), which runs after the generic
    pass, so a module's own rule wins over its children's."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)):
            w = module.weight
            w.normal_(0.0, 1.0 / math.sqrt(w[0].numel()), generator=generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, 1.0 / math.sqrt(module.weight.shape[1]), generator=generator)
        elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
    for module in model.modules():
        if hasattr(module, "init_from"):
            module.init_from(generator)
    return model


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
