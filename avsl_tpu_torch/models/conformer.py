"""Auto-AVSR's audio-visual model in PyTorch: two Conformer encoders with
relative-position attention, the fusion MLP, the CTC head, the Transformer
decoder and the joint CTC/attention loss.

After mpc001/auto_avsr (``audiovisual_backbone``; arXiv:2303.14307), whose
modules are ESPnet's (Gulati et al., arXiv:2005.08100, with the "latest"
relative positional encoding of Transformer-XL, arXiv:1901.02860):

* the lips' encoder runs the 3-D stem and ResNet-18 trunk of
  :mod:`.resnet3d` with swish (``Conv3dResNet``), the audio's the
  ResNet-1D over raw 16 kHz PCM (``Conv1dResNet``: a k = 80, stride 4
  conv, BasicBlock1D stages [2, 2, 2, 2] at strides 1/2/2/2, an average
  pool of k = 21, stride 20, pad 1; 640 samples a frame, a trailing
  partial frame cut first); each projects to ``adim``, scales by
  sqrt(adim) and draws dropout on it and on the relative positions
  (:func:`rel_positions`, 2T - 1 rows for T - 1 ... -(T - 1));
* each of the ``elayers`` blocks is the macaron Conformer block, pre-norm:
  ``x += drop(FFN(LN x)) / 2``, ``x += drop(MHSA_rel(LN x))``, ``x +=
  drop(Conv(LN x))``, ``x += drop(FFN(LN x)) / 2``, then ``LN``; the FFN
  is ``w_2(drop(swish(w_1 x)))``; the conv module a pointwise conv to 2C,
  GLU, a depthwise conv, BatchNorm, swish and a pointwise conv, with no
  padding mask; the encoder ends in ``after_norm``;
* :func:`rel_position_attention`: scores ``((q + u) k^T + rel_shift((q +
  v) p^T)) / sqrt(D)``, masked softmax, dropout on the weights, the
  weighted sum, ``linear_out``;
* the fusion MLP ``fc2(relu(BN(fc1(cat(video, audio)))))`` over the
  lips' frames, the CTC head ``ctc_lo`` (its input dropped first, as
  ESPnet's CTC does), and the decoder: sqrt(ddim)-scaled embeddings with
  interleaved sinusoids, pre-norm blocks of causal self-attention, source
  attention onto the fused sequence and a ReLU FFN, ``after_norm`` and an
  untied ``output_layer``;
* the loss (:func:`joint_loss`): ``mtlalpha`` x the CTC loss (summed over
  the batch, over B) plus the rest x ESPnet's KL label smoothing (summed,
  over B).

Numerics follow :mod:`.layers`: fp32 weights cast to the compute dtype at
use, layer norms (eps 1e-12, ESPnet's), BatchNorm, the relative-position
biases ``pos_bias_u`` / ``pos_bias_v`` and both losses in fp32, attention
scores and softmax in fp32 (the einsum path, never K1/K2: the score term
has no place in them, and the decoder's masked attention takes the
unfused path too). In training every dropout draws from the forward's
``generator``, in this order: the lips' encoder (the embedding, the
positions, then each block's macaron FFN activation and output, attention
weights and output, conv output, FFN activation and output), the audio's
alike, the CTC input, the decoder (the embedding, then each block's
self-attention weights and output, source-attention weights and output,
FFN activation and output). BatchNorm uses the batch's statistics in
training.

State-dict names are ESPnet's: ``encoder`` and ``aux_encoder``
(``frontend``, ``embed.0``, ``encoders.N.{feed_forward_macaron,
self_attn, conv_module, feed_forward, norm_ff_macaron, norm_mha,
norm_conv, norm_ff, norm_final}``, ``after_norm``), ``fusion.{fc1, bn1,
fc2}``, ``ctc.ctc_lo``, ``decoder.{embed.0, decoders.N.{self_attn,
src_attn, feed_forward, norm1, norm2, norm3}, after_norm,
output_layer}``.

Spans (:mod:`avsl_tpu_torch.utils.spans`): ``avsr.frontend`` (both
ResNets), ``avsr.conformer`` (both embeddings and Conformer stacks); the
loss closure (``train/objectives.py``) adds ``avsr.head``. The counter
``avsr.relpos_bytes`` adds the bytes of each forward's positional score
tensors: the [B, H, T, 2T - 1] products and their [B, H, T, 2T]
zero-padded copy that :func:`rel_shift` makes.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avsl_tpu_torch.core.config import AutoAVSRConfig
from avsl_tpu_torch.models.layers import (
    CastConv1d,
    CastLinear,
    LayerNormF32,
    MultiHeadAttention,
    _matmul_f32,
    cast_param,
    residual_dropout,
    torch_dtype,
)
from avsl_tpu_torch.models.resnet3d import BatchNormF32, ResNet3DFrontend
from avsl_tpu_torch.utils.spans import count, span

# PCM samples a frame of the ResNet-1D: its strides 4 x 2 x 2 x 2 x 20
AUDIO_FRAME_SAMPLES = 640
# labels the attention loss ignores
IGNORE_ID = -100
# the CTC blank: the vocabulary's first row
BLANK_ID = 0
# ESPnet's LayerNorm
LAYER_NORM_EPS = 1e-12


def rel_positions(length: int, d: int) -> np.ndarray:
    """ESPnet's "latest" relative positional encoding: [2T - 1, d] rows for
    the relative positions T - 1 down to -(T - 1), sin in the even columns
    and cos in the odd ones."""
    pos = np.arange(length - 1, -length, -1, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(10000.0) / d))
    out = np.zeros((2 * length - 1, d), np.float64)
    out[:, 0::2] = np.sin(pos * div)
    out[:, 1::2] = np.cos(pos * div)
    return out.astype(np.float32)


def abs_positions(length: int, d: int) -> np.ndarray:
    """ESPnet's absolute sinusoids (the decoder's): [length, d] for the
    positions 0 ... length - 1, sin in the even columns and cos in the odd
    ones."""
    return rel_positions(length, d)[length - 1::-1].copy()


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[..., T, 2T - 1] scores by relative position -> [..., T, T] with
    entry (i, j) the score for i - j: pad a zero column, view [T, 2T] as
    [2T, T], drop the first row, view back and keep T columns."""
    *lead, t, n = x.shape
    padded = torch.cat([x.new_zeros(*lead, t, 1), x], dim=-1)
    return padded.view(*lead, n + 1, t)[..., 1:, :].reshape(*lead, t, n)[..., : n // 2 + 1]


def rel_position_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           p: torch.Tensor, bias_u: torch.Tensor, bias_v: torch.Tensor,
                           mask: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Transformer-XL attention, [B, T, H, D] q, k, v with the projected
    positions ``p`` [2T - 1, H, D] and the fp32 biases [H, D] -> [B, T, H,
    D]: the fp32 scores ``((q + u) k^T + rel_shift((q + v) p^T)) / sqrt(D)``,
    ``mask`` [B, 1, 1, T] (True = attend) filled with ``finfo.min``, an fp32
    softmax, the weights cast to ``q.dtype`` and dropped (``dropout_rate``,
    from ``generator``), and the fp32-accumulated weighted sum."""
    b, t, h, d = q.shape
    qh = q.float().transpose(1, 2)
    ac = _matmul_f32(qh + bias_u[:, None], k.transpose(1, 2).transpose(-1, -2))
    bd = _matmul_f32(qh + bias_v[:, None], p.permute(1, 2, 0))
    count("avsr.relpos_bytes", bd.element_size() * b * h * t * (4 * t - 1))
    logits = (ac + rel_shift(bd)) * (1.0 / math.sqrt(d))
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    weights = residual_dropout(probs.to(q.dtype), dropout_rate, True, generator)
    return _matmul_f32(weights, v.transpose(1, 2)).to(q.dtype).transpose(1, 2)


class RelPositionMultiHeadAttention(nn.Module):
    """ESPnet's ``RelPositionMultiHeadedAttention``: ``linear_q``,
    ``linear_k``, ``linear_v``, ``linear_out`` (with biases), ``linear_pos``
    (no bias) and the fp32 ``pos_bias_u``, ``pos_bias_v`` [H, D]."""

    def __init__(self, d_model: int, n_heads: int, dropout: float = 0.0,
                 dtype=torch.bfloat16, param_dtype=None, device=None):
        super().__init__()
        self.n_heads, self.head_dim, self.dropout = n_heads, d_model // n_heads, dropout
        kw = dict(device=device, param_dtype=param_dtype or dtype, compute_dtype=dtype)
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            self.add_module(name, CastLinear(d_model, d_model, **kw))
        self.linear_pos = CastLinear(d_model, d_model, bias=False, **kw)
        f32 = dict(device=device, dtype=torch.float32)
        self.pos_bias_u = nn.Parameter(torch.empty(n_heads, self.head_dim, **f32))
        self.pos_bias_v = nn.Parameter(torch.empty(n_heads, self.head_dim, **f32))

    @torch.no_grad()
    def init_from(self, generator: torch.Generator) -> None:
        bound = math.sqrt(6.0 / (self.n_heads + self.head_dim))  # xavier_uniform, as ESPnet
        for bias in (self.pos_bias_u, self.pos_bias_v):
            bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, pos: torch.Tensor, mask: Optional[torch.Tensor],
                generator: Optional[torch.Generator]) -> torch.Tensor:
        b, t, _ = x.shape
        q, k, v = (m(x).view(b, t, self.n_heads, self.head_dim)
                   for m in (self.linear_q, self.linear_k, self.linear_v))
        p = self.linear_pos(pos).view(-1, self.n_heads, self.head_dim)
        out = rel_position_attention(q, k, v, p, self.pos_bias_u, self.pos_bias_v, mask,
                                     self.dropout if self.training else 0.0, generator)
        return self.linear_out(out.reshape(b, t, -1))


class FeedForward(nn.Module):
    """ESPnet's ``PositionwiseFeedForward``: ``w_2(drop(act(w_1 x)))``, act
    swish (the Conformer's) or ReLU (the decoder's)."""

    def __init__(self, d_model: int, d_ff: int, dropout: float, activation: str,
                 dtype=torch.bfloat16, param_dtype=None, device=None):
        super().__init__()
        kw = dict(device=device, param_dtype=param_dtype or dtype, compute_dtype=dtype)
        self.w_1 = CastLinear(d_model, d_ff, **kw)
        self.w_2 = CastLinear(d_ff, d_model, **kw)
        self.dropout = dropout
        self.act = F.silu if activation == "swish" else F.relu

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        h = residual_dropout(self.act(self.w_1(x)), self.dropout, self.training, generator)
        return self.w_2(h)


class ConvolutionModule(nn.Module):
    """The Conformer's conv module on [B, T, C]: ``pointwise_conv1`` (C ->
    2C, as a product over the channels), GLU, ``depthwise_conv`` (k, pad
    (k - 1) / 2, a bias), ``norm`` (BatchNorm over the channels, fp32),
    swish, ``pointwise_conv2``. No padding mask, as published."""

    def __init__(self, channels: int, kernel: int, dtype=torch.bfloat16, param_dtype=None,
                 device=None):
        super().__init__()
        kw = dict(device=device, param_dtype=param_dtype or dtype, compute_dtype=dtype)
        self.pointwise_conv1 = CastConv1d(channels, 2 * channels, 1, **kw)
        self.depthwise_conv = CastConv1d(channels, channels, kernel, padding=(kernel - 1) // 2,
                                         groups=channels, **kw)
        self.norm = BatchNormF32(channels, device=device)
        self.pointwise_conv2 = CastConv1d(channels, channels, 1, **kw)

    @staticmethod
    def _pointwise(conv: CastConv1d, x: torch.Tensor) -> torch.Tensor:
        dtype = conv.compute_dtype
        return F.linear(x, cast_param(conv.weight, dtype)[..., 0], cast_param(conv.bias, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.glu(self._pointwise(self.pointwise_conv1, x), dim=-1)
        h = self.depthwise_conv(h.transpose(1, 2))
        h = F.silu(self.norm(h, use_running_average=not self.training))
        return self._pointwise(self.pointwise_conv2, h.transpose(1, 2))


class ConformerBlock(nn.Module):
    """ESPnet's Conformer ``EncoderLayer`` (macaron, pre-norm, the conv
    module, ``norm_final``)."""

    def __init__(self, cfg: AutoAVSRConfig, dtype=torch.bfloat16, param_dtype=None, device=None):
        super().__init__()
        d, rate = cfg.adim, cfg.dropout_rate
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.self_attn = RelPositionMultiHeadAttention(d, cfg.aheads,
                                                       cfg.transformer_attn_dropout_rate, **kw)
        self.feed_forward = FeedForward(d, cfg.eunits, rate, "swish", **kw)
        self.feed_forward_macaron = FeedForward(d, cfg.eunits, rate, "swish", **kw)
        self.conv_module = ConvolutionModule(d, cfg.cnn_module_kernel, **kw)
        for name in ("norm_ff", "norm_mha", "norm_ff_macaron", "norm_conv", "norm_final"):
            self.add_module(name, LayerNormF32(d, eps=LAYER_NORM_EPS, device=device))
        self.dropout = rate

    def _drop(self, x, generator):
        return residual_dropout(x, self.dropout, self.training, generator)

    def forward(self, x: torch.Tensor, pos: torch.Tensor, mask: Optional[torch.Tensor],
                generator: Optional[torch.Generator]) -> torch.Tensor:
        x = x + 0.5 * self._drop(self.feed_forward_macaron(self.norm_ff_macaron(x), generator),
                                 generator)
        x = x + self._drop(self.self_attn(self.norm_mha(x), pos, mask, generator), generator)
        x = x + self._drop(self.conv_module(self.norm_conv(x)), generator)
        x = x + 0.5 * self._drop(self.feed_forward(self.norm_ff(x), generator), generator)
        return self.norm_final(x)


class BasicBlock1D(nn.Module):
    """ResNet-1D basic block: conv3 (stride) -> BN -> swish -> conv3 -> BN,
    plus the identity or a 1-wide strided conv + BN, then swish."""

    def __init__(self, in_planes: int, planes: int, stride: int, dtype=torch.bfloat16,
                 param_dtype=None, device=None):
        super().__init__()
        kw = dict(bias=False, device=device, param_dtype=param_dtype or dtype, compute_dtype=dtype)
        self.conv1 = CastConv1d(in_planes, planes, 3, stride=stride, padding=1, **kw)
        self.bn1 = BatchNormF32(planes, device=device)
        self.conv2 = CastConv1d(planes, planes, 3, padding=1, **kw)
        self.bn2 = BatchNormF32(planes, device=device)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(CastConv1d(in_planes, planes, 1, stride=stride, **kw),
                                            BatchNormF32(planes, device=device))

    def forward(self, x: torch.Tensor, use_running_average: bool) -> torch.Tensor:
        out = F.silu(self.bn1(self.conv1(x), use_running_average))
        out = self.bn2(self.conv2(out), use_running_average)
        if self.downsample is not None:
            x = self.downsample[1](self.downsample[0](x), use_running_average)
        return F.silu(out + x)


class ResNet1D(nn.Module):
    """The audio trunk: ``conv1`` (1 -> planes[0], k 80, stride 4, pad 38,
    no bias), ``bn1``, swish, four stages of two :class:`BasicBlock1D`
    (strides 1, 2, 2, 2) and an average pool (k 21, stride 20, pad 1):
    [B, 1, S] -> [B, planes[-1], S / 640]."""

    def __init__(self, backbone_channels: int, dtype=torch.bfloat16, param_dtype=None,
                 device=None):
        super().__init__()
        bc = backbone_channels
        planes = (max(bc // 8, 8), max(bc // 4, 8), max(bc // 2, 8), bc)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.conv1 = CastConv1d(1, planes[0], 80, stride=4, padding=38, bias=False, device=device,
                                param_dtype=param_dtype or dtype, compute_dtype=dtype)
        self.bn1 = BatchNormF32(planes[0], device=device)
        in_planes = planes[0]
        for stage, width in enumerate(planes):
            blocks = [BasicBlock1D(in_planes, width, 1 if stage == 0 else 2, **kw),
                      BasicBlock1D(width, width, 1, **kw)]
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            in_planes = width

    def forward(self, x: torch.Tensor, use_running_average: bool) -> torch.Tensor:
        x = F.silu(self.bn1(self.conv1(x), use_running_average))
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                x = block(x, use_running_average)
        return F.avg_pool1d(x, kernel_size=21, stride=20, padding=1)


class Conv1dResNet(nn.Module):
    """The audio frontend: PCM [B, S] -> [B, S // 640, backbone_channels],
    the trailing partial frame cut first."""

    def __init__(self, backbone_channels: int, dtype=torch.bfloat16, param_dtype=None,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.trunk = ResNet1D(backbone_channels, dtype=dtype, param_dtype=param_dtype,
                              device=device)

    def forward(self, pcm: torch.Tensor, use_running_average: bool = True) -> torch.Tensor:
        s = pcm.shape[1] // AUDIO_FRAME_SAMPLES * AUDIO_FRAME_SAMPLES
        x = pcm[:, None, :s].to(self.dtype)
        return self.trunk(x, use_running_average).transpose(1, 2)


class ConformerEncoder(nn.Module):
    """One modality's encoder: ``frontend`` (:class:`ResNet3DFrontend` with
    swish for the lips, :class:`Conv1dResNet` for the audio), ``embed.0``
    (backbone channels -> adim), ``encoders`` and ``after_norm``."""

    def __init__(self, cfg: AutoAVSRConfig, modality: str, device=None):
        super().__init__()
        dtype, pdtype = torch_dtype(cfg.dtype), torch_dtype(cfg.param_dtype)
        kw = dict(dtype=dtype, param_dtype=pdtype, device=device)
        if modality == "video":
            self.frontend = ResNet3DFrontend(cfg.visual_frontend_channels,
                                             cfg.visual_backbone_channels, relu_type="swish", **kw)
            width = cfg.visual_backbone_channels
        else:
            self.frontend = Conv1dResNet(cfg.audio_backbone_channels, **kw)
            width = cfg.audio_backbone_channels
        self.embed = nn.Sequential(CastLinear(width, cfg.adim, device=device, param_dtype=pdtype,
                                              compute_dtype=dtype))
        self.encoders = nn.ModuleList(ConformerBlock(cfg, **kw) for _ in range(cfg.elayers))
        self.after_norm = LayerNormF32(cfg.adim, eps=LAYER_NORM_EPS, device=device)
        self.adim, self.dropout = cfg.adim, cfg.dropout_rate
        self._pe: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def positions(self, length: int, device) -> torch.Tensor:
        """The [2T - 1, adim] relative positions in the compute dtype, made
        once a length and device."""
        key = (length, torch.device(device))
        if key not in self._pe:
            table = torch.from_numpy(rel_positions(length, self.adim))
            self._pe[key] = table.to(device=device, dtype=self.embed[0].compute_dtype)
        return self._pe[key]

    def blocks(self, feats: torch.Tensor, valid: Optional[torch.Tensor],
               generator: Optional[torch.Generator]) -> torch.Tensor:
        """Frontend features [B, T, C] -> [B, T, adim]; ``valid`` [B, T]
        (True = a frame) masks the attention's keys."""
        x = self.embed[0](feats) * math.sqrt(self.adim)
        x = residual_dropout(x, self.dropout, self.training, generator)
        pos = residual_dropout(self.positions(x.shape[1], x.device)[None], self.dropout,
                               self.training, generator)[0]
        mask = None if valid is None else valid[:, None, None, :]
        for block in self.encoders:
            x = block(x, pos, mask, generator)
        return self.after_norm(x)


class MLPHead(nn.Module):
    """The fusion: ``fc2(relu(bn1(fc1 x)))``, BatchNorm over the hidden
    features of every frame."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int, dtype=torch.bfloat16,
                 param_dtype=None, device=None):
        super().__init__()
        kw = dict(device=device, param_dtype=param_dtype or dtype, compute_dtype=dtype)
        self.fc1 = CastLinear(d_in, d_hidden, **kw)
        self.bn1 = BatchNormF32(d_hidden, device=device)
        self.fc2 = CastLinear(d_hidden, d_out, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn1(self.fc1(x).transpose(1, 2), use_running_average=not self.training)
        return self.fc2(F.relu(h.transpose(1, 2)))


class DecoderLayer(nn.Module):
    """ESPnet's pre-norm ``DecoderLayer``: causal self-attention, source
    attention, a ReLU FFN, each with dropout on its output."""

    def __init__(self, cfg: AutoAVSRConfig, dtype=torch.bfloat16, param_dtype=None, device=None):
        super().__init__()
        d, rate = cfg.ddim, cfg.dropout_rate
        mha = dict(dtype=dtype, param_dtype=param_dtype, device=device, use_k_bias=True,
                   names="espnet", attn_dropout=cfg.transformer_attn_dropout_rate)
        self.self_attn = MultiHeadAttention(d, cfg.dheads, **mha)
        self.src_attn = MultiHeadAttention(d, cfg.dheads, kv_dim=cfg.adim, **mha)
        self.feed_forward = FeedForward(d, cfg.dunits, rate, "relu", dtype=dtype,
                                        param_dtype=param_dtype, device=device)
        for name in ("norm1", "norm2", "norm3"):
            self.add_module(name, LayerNormF32(d, eps=LAYER_NORM_EPS, device=device))
        self.dropout = rate

    def forward(self, x, memory, self_mask, memory_mask, generator):
        def drop(h):
            return residual_dropout(h, self.dropout, self.training, generator)

        x = x + drop(self.self_attn(self.norm1(x), generator=generator, mask=self_mask)[0])
        x = x + drop(self.src_attn(self.norm2(x), kv_src=memory, generator=generator,
                                   mask=memory_mask)[0])
        return x + drop(self.feed_forward(self.norm3(x), generator))


class TransformerDecoder(nn.Module):
    """ESPnet's Transformer decoder: ``embed.0`` (the token embedding,
    scaled by sqrt(ddim), plus sinusoids, then dropout), ``decoders``,
    ``after_norm`` and the untied ``output_layer`` with a bias."""

    def __init__(self, cfg: AutoAVSRConfig, device=None):
        super().__init__()
        dtype, pdtype = torch_dtype(cfg.dtype), torch_dtype(cfg.param_dtype)
        self.dtype = dtype
        self.embed = nn.Sequential(nn.Embedding(cfg.odim, cfg.ddim, device=device, dtype=pdtype))
        self.decoders = nn.ModuleList(DecoderLayer(cfg, dtype, pdtype, device)
                                      for _ in range(cfg.dlayers))
        self.after_norm = LayerNormF32(cfg.ddim, eps=LAYER_NORM_EPS, device=device)
        self.output_layer = CastLinear(cfg.ddim, cfg.odim, device=device, param_dtype=pdtype,
                                       compute_dtype=dtype)
        self.ddim, self.dropout = cfg.ddim, cfg.dropout_rate
        self._pe: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def forward(self, tokens: torch.Tensor, memory: torch.Tensor,
                memory_valid: Optional[torch.Tensor],
                generator: Optional[torch.Generator]) -> torch.Tensor:
        length, d = tokens.shape[1], self.ddim
        key = (length, tokens.device)
        if key not in self._pe:
            self._pe[key] = torch.from_numpy(abs_positions(length, d)).to(tokens.device,
                                                                           self.dtype)
        x = cast_param(self.embed[0](tokens), self.dtype) * math.sqrt(d) + self._pe[key]
        x = residual_dropout(x, self.dropout, self.training, generator)
        causal = torch.ones((length, length), dtype=torch.bool, device=tokens.device).tril()
        memory_mask = None if memory_valid is None else memory_valid[:, None, None, :]
        for layer in self.decoders:
            x = layer(x, memory, causal[None, None], memory_mask, generator)
        return self.output_layer(self.after_norm(x))


class CTCHead(nn.Module):
    """``ctc_lo``: the fused sequence -> per-frame vocabulary logits."""

    def __init__(self, cfg: AutoAVSRConfig, device=None):
        super().__init__()
        self.ctc_lo = CastLinear(cfg.adim, cfg.odim, device=device,
                                 param_dtype=torch_dtype(cfg.param_dtype),
                                 compute_dtype=torch_dtype(cfg.dtype))


class AutoAVSR(nn.Module):
    """The audio-visual model: ``encoder`` (the lips), ``aux_encoder``
    (the audio), ``fusion``, ``ctc`` and ``decoder``. The loss closure
    calls :meth:`encode` then :meth:`heads`."""

    def __init__(self, cfg: AutoAVSRConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype, pdtype = torch_dtype(cfg.dtype), torch_dtype(cfg.param_dtype)
        self.encoder = ConformerEncoder(cfg, "video", device=device)
        self.aux_encoder = ConformerEncoder(cfg, "audio", device=device)
        self.fusion = MLPHead(2 * cfg.adim, cfg.fusion_hdim, cfg.adim, dtype, pdtype, device)
        self.ctc = CTCHead(cfg, device=device)
        self.decoder = TransformerDecoder(cfg, device=device)

    def encode(self, video: torch.Tensor, audio: torch.Tensor,
               video_lengths: Optional[torch.Tensor] = None,
               audio_lengths: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """Lip frames [B, T, H, W] (normalised) and PCM [B, S] -> the two
        encoders' outputs [B, T', adim], both cut to the shorter, and the
        video frames' validity [B, T'] (None without ``video_lengths``),
        which the CTC and the decoder take, as auto_avsr's E2E. Each
        encoder masks by its own stream: the lips' by ``video_lengths``, the
        audio's by ``audio_lengths`` in whole frames."""
        running = not self.training  # BatchNorm on the batch's statistics in training
        with span("avsr.frontend"):
            fv = self.encoder.frontend(video, running)
            fa = self.aux_encoder.frontend(audio, running)
        t = min(fv.shape[1], fa.shape[1])
        fv, fa = fv[:, :t], fa[:, :t]
        frames = torch.arange(t, device=fv.device)[None, :]
        valid = a_valid = None
        if video_lengths is not None:
            valid = frames < video_lengths.to(fv.device)[:, None]
        if audio_lengths is not None:
            a_valid = frames < audio_lengths.to(fv.device)[:, None] // AUDIO_FRAME_SAMPLES
        with span("avsr.conformer"):
            v = self.encoder.blocks(fv, valid, generator)
            a = self.aux_encoder.blocks(fa, a_valid, generator)
        return v, a, valid

    def heads(self, v: torch.Tensor, a: torch.Tensor, valid: Optional[torch.Tensor],
              dec_input_ids: torch.Tensor, generator: Optional[torch.Generator] = None):
        """The fusion, the CTC head (its input dropped first) and the
        teacher-forced decoder: ``(ctc_logits [B, T, odim], logits [B, L,
        odim])`` in the compute dtype."""
        x = self.fusion(torch.cat([v, a], dim=-1))
        ctc_in = residual_dropout(x, self.cfg.dropout_rate, self.training, generator)
        ctc_logits = self.ctc.ctc_lo(ctc_in)
        logits = self.decoder(dec_input_ids, x, valid, generator)
        return ctc_logits, logits


def ctc_loss_sum(ctc_logits: torch.Tensor, lengths: Optional[torch.Tensor],
                 targets: torch.Tensor, target_lengths: torch.Tensor) -> torch.Tensor:
    """ESPnet's builtin CTC: fp32 log-softmax, ``F.ctc_loss`` summed over
    the batch with infinite losses zeroed, divided by B. ``targets`` [B,
    L] (read up to ``target_lengths``), ``lengths`` [B] the frames (all T
    when None)."""
    b, t = ctc_logits.shape[:2]
    logp = torch.log_softmax(ctc_logits.float(), dim=-1).transpose(0, 1)
    if lengths is None:
        lengths = torch.full((b,), t, dtype=torch.long, device=ctc_logits.device)
    loss = F.ctc_loss(logp, targets, lengths, target_lengths, blank=BLANK_ID, reduction="sum",
                      zero_infinity=True)
    return loss / b


def label_smoothing_loss(logits: torch.Tensor, labels: torch.Tensor, smoothing: float,
                         ignore_id: int = IGNORE_ID) -> torch.Tensor:
    """ESPnet's ``LabelSmoothingLoss``: KL(smoothed target || softmax) over
    the vocabulary, the target ``1 - smoothing`` on the label and
    ``smoothing / (V - 1)`` elsewhere, summed over the labels that are not
    ``ignore_id`` and divided by B; fp32, in closed form."""
    v = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels != ignore_id
    conf, low = 1.0 - smoothing, smoothing / (v - 1)
    entropy = conf * math.log(conf) + (low * (v - 1) * math.log(low) if low > 0 else 0.0)
    picked = logp.gather(-1, torch.where(valid, labels, 0)[..., None])[..., 0]
    kl = entropy - low * logp.sum(dim=-1) - (conf - low) * picked
    return torch.where(valid, kl, 0.0).sum() / labels.shape[0]


def joint_loss(cfg: AutoAVSRConfig, ctc_logits: torch.Tensor, logits: torch.Tensor,
               valid: Optional[torch.Tensor], batch: Dict[str, torch.Tensor]):
    """``mtlalpha x CTC + (1 - mtlalpha) x attention``; returns ``(loss,
    loss_ctc, loss_att)``. ``batch`` holds ``targets`` and
    ``target_lengths`` (the CTC's) and ``labels`` (the decoder's)."""
    lengths = None if valid is None else valid.sum(dim=-1)
    loss_ctc = ctc_loss_sum(ctc_logits, lengths, batch["targets"], batch["target_lengths"])
    loss_att = label_smoothing_loss(logits, batch["labels"], cfg.lsm_weight)
    return cfg.mtlalpha * loss_ctc + (1.0 - cfg.mtlalpha) * loss_att, loss_ctc, loss_att
