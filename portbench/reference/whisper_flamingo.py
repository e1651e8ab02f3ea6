"""Whisper-Flamingo in plain PyTorch: Whisper large-v2 (arXiv:2212.04356,
openai/whisper ``model.py``) with the AV-HuBERT large video encoder
(arXiv:2201.02184, fairseq ``avhubert``) feeding tanh-gated
cross-attention sublayers in every decoder block (Whisper-Flamingo,
arXiv:2406.10082).

Every function reads the weights from ``W``, a dict keyed by the OpenAI
Whisper and fairseq state-dict names (``encoder.blocks.0.attn.query.weight``,
``video_model.encoder.layers.0.self_attn.q_proj.weight``, ...), in fp32.
Products go through a :class:`~portbench.reference.precision.Precision`.
Random draws (dropout, LayerDrop) go through a :class:`Draws`, which
draws each mask from one explicit generator in the order the layers run:
the Whisper encoder's blocks, then the video tower, then the decoder's
blocks, each block's sublayers in order. Departures from the published
models: none beyond random weights; the video stream is the AV-HuBERT
encoder run on the lip clip alone (``modality_fuse`` "add" with no audio
stream), as Whisper-Flamingo uses it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.precision import Precision

Weights = Dict[str, torch.Tensor]


class Draws:
    """The random draws of a forward: none outside training; in training
    each dropout mask is ``rand(shape) < 1 - rate`` from ``generator``
    (kept elements scaled by ``1 / (1 - rate)``) and each LayerDrop keeps
    its layer when one scalar draw is below ``1 - rate``."""

    def __init__(self, generator: Optional[torch.Generator] = None, train: bool = False):
        self.generator, self.train = generator, train

    def drop(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if not self.train or rate <= 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))

    def scalar(self, device) -> torch.Tensor:
        return torch.rand((), generator=self.generator, device=device)


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> torch.Tensor:
    """Whisper's encoder positions: [length, channels], sin then cos."""
    inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32))


def layer_norm(x, W: Weights, name: str, eps: float = 1e-5):
    return F.layer_norm(x, (x.shape[-1],), W[name + ".weight"], W[name + ".bias"], eps)


def linear(P: Precision, x, W: Weights, name: str):
    y = P.mm(x, W[name + ".weight"])
    bias = W.get(name + ".bias")
    return y if bias is None else y + bias


def attention(P: Precision, q, k, v, heads: int, causal: bool = False,
              key_lengths: Optional[torch.Tensor] = None, draws: Optional[Draws] = None,
              drop_rate: float = 0.0):
    """Scaled dot-product attention of [B, Tq, H*D] queries on [B, Tk, H*D]
    keys and values, with a causal mask, key lengths, and dropout on the
    [B, H, Tq, Tk] weights."""
    b, tq, width = q.shape
    tk = k.shape[1]
    d = width // heads
    q = q.view(b, tq, heads, d).transpose(1, 2)
    k = k.view(b, tk, heads, d).transpose(1, 2)
    v = v.view(b, tk, heads, d).transpose(1, 2)
    logits = P.bmm(q, k.transpose(-1, -2)) / math.sqrt(d)
    mask = None
    if causal:
        mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril(tk - tq)[None, None]
    if key_lengths is not None:
        keys = torch.arange(tk, device=q.device)[None, :] < key_lengths.to(q.device)[:, None]
        keys = keys[:, None, None, :]
        mask = keys if mask is None else mask & keys
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    if mask is not None:
        probs = torch.nan_to_num(probs)  # a row with no key attends to nothing
    if draws is not None and drop_rate > 0.0:
        probs = draws.drop(probs, drop_rate)
    out = P.bmm(probs, v)
    return out.transpose(1, 2).reshape(b, tq, width)


def mha(P: Precision, x, kv, W: Weights, name: str, heads: int, names=("query", "key", "value",
                                                                         "out"), **kw):
    q = linear(P, x, W, f"{name}.{names[0]}")
    k = linear(P, kv, W, f"{name}.{names[1]}")
    v = linear(P, kv, W, f"{name}.{names[2]}")
    return linear(P, attention(P, q, k, v, heads, **kw), W, f"{name}.{names[3]}")


def mlp(P: Precision, x, W: Weights, name: str):
    return linear(P, F.gelu(linear(P, x, W, f"{name}.0")), W, f"{name}.2")


def conv1d(P: Precision, x, w, b, **kw):
    return F.conv1d(P.op(x), P.op(w), b, **kw)


# ---------------------------------------------------------------- Whisper


def whisper_encoder(P: Precision, W: Weights, cfg: dict, mel, draws: Draws, rate: float = 0.0):
    """mel [B, n_mels, T] -> [B, T/2, n_audio_state]; ``rate`` the residual
    dropout of the blocks (training)."""
    x = F.gelu(conv1d(P, mel, W["encoder.conv1.weight"], W["encoder.conv1.bias"], padding=1))
    x = F.gelu(conv1d(P, x, W["encoder.conv2.weight"], W["encoder.conv2.bias"], stride=2,
                      padding=1))
    x = x.transpose(1, 2)
    x = x + sinusoids(cfg["n_audio_ctx"], cfg["n_audio_state"]).to(x.device)[: x.shape[1]]
    heads = cfg["n_audio_head"]
    for i in range(cfg["n_audio_layer"]):
        pre = f"encoder.blocks.{i}"
        h = layer_norm(x, W, f"{pre}.attn_ln")
        x = x + draws.drop(mha(P, h, h, W, f"{pre}.attn", heads), rate)
        x = x + draws.drop(mlp(P, layer_norm(x, W, f"{pre}.mlp_ln"), W, f"{pre}.mlp"), rate)
    return layer_norm(x, W, "encoder.ln_post")


def whisper_decoder(P: Precision, W: Weights, cfg: dict, tokens, audio_features, xv,
                    draws: Draws, rate: float = 0.0):
    """Teacher-forced logits [B, L, n_vocab] of ``tokens`` [B, L] over the
    audio features and the projected video stream ``xv`` (the gated
    sublayers run first in every block, with no dropout on their deltas)."""
    emb = W["decoder.token_embedding.weight"]
    x = emb[tokens] + W["decoder.positional_embedding"][: tokens.shape[1]]
    heads = cfg["n_text_head"]
    for i in range(cfg["n_text_layer"]):
        pre = f"decoder.blocks.{i}"
        if xv is not None:
            h = layer_norm(x, W, f"{pre}.x_attn_ln")
            x = x + torch.tanh(W[f"{pre}.x_attn_gate"]) * mha(P, h, xv, W, f"{pre}.x_attn", heads)
            h = layer_norm(x, W, f"{pre}.x_mlp_ln")
            x = x + torch.tanh(W[f"{pre}.x_mlp_gate"]) * mlp(P, h, W, f"{pre}.x_mlp")
        h = layer_norm(x, W, f"{pre}.attn_ln")
        x = x + draws.drop(mha(P, h, h, W, f"{pre}.attn", heads, causal=True), rate)
        h = layer_norm(x, W, f"{pre}.cross_attn_ln")
        x = x + draws.drop(mha(P, h, audio_features, W, f"{pre}.cross_attn", heads), rate)
        x = x + draws.drop(mlp(P, layer_norm(x, W, f"{pre}.mlp_ln"), W, f"{pre}.mlp"), rate)
    x = layer_norm(x, W, "decoder.ln")
    return P.mm(x, emb)


# ------------------------------------------------------------ video tower


def batch_norm(x, W: Weights, name: str, batch_stats: bool, eps: float = 1e-5):
    """Over dim 1: the batch's mean and biased variance in training, the
    running statistics otherwise."""
    shape = [1, -1] + [1] * (x.ndim - 2)
    if batch_stats:
        axes = [d for d in range(x.ndim) if d != 1]
        mean = x.mean(dim=axes)
        var = (x - mean.view(shape)).square().mean(dim=axes)
    else:
        mean, var = W[name + ".running_mean"], W[name + ".running_var"]
    scale = W[name + ".weight"] / torch.sqrt(var + eps)
    return (x - mean.view(shape)) * scale.view(shape) + W[name + ".bias"].view(shape)


def conv2d(P: Precision, x, w, **kw):
    return F.conv2d(P.op(x), P.op(w), None, **kw)


def basic_block(P, W, name, x, stride, batch_stats):
    out = conv2d(P, x, W[f"{name}.conv1.weight"], stride=stride, padding=1)
    out = F.prelu(batch_norm(out, W, f"{name}.bn1", batch_stats), W[f"{name}.relu1.weight"])
    out = batch_norm(conv2d(P, out, W[f"{name}.conv2.weight"], padding=1), W, f"{name}.bn2",
                     batch_stats)
    if f"{name}.downsample.0.weight" in W:
        x = batch_norm(conv2d(P, x, W[f"{name}.downsample.0.weight"], stride=stride), W,
                       f"{name}.downsample.1", batch_stats)
    return F.prelu(out + x, W[f"{name}.relu2.weight"])


def resnet(P: Precision, W: Weights, pre: str, video, batch_stats: bool):
    """Lip frames [B, T, H, W] -> [B, T, 512]: the Conv3D stem (k 5x7x7,
    stride 1x2x2) with BatchNorm and PReLU, a 3x3 max pool, then each
    frame through a ResNet-18 trunk and a global mean."""
    b, t = video.shape[:2]
    x = F.conv3d(P.op(video[:, None]), P.op(W[f"{pre}.frontend3D.0.weight"]), None,
                 stride=(1, 2, 2), padding=(2, 3, 3))
    x = F.prelu(batch_norm(x, W, f"{pre}.frontend3D.1", batch_stats),
                W[f"{pre}.frontend3D.2.weight"])
    x = x.transpose(1, 2).reshape(b * t, x.shape[1], x.shape[3], x.shape[4])
    x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
    for stage in range(1, 5):
        for blk in range(2):
            stride = 2 if stage > 1 and blk == 0 else 1
            x = basic_block(P, W, f"{pre}.trunk.layer{stage}.{blk}", x, stride, batch_stats)
    return x.mean(dim=(2, 3)).view(b, t, -1)


class _GradScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def avhubert_encoder(P: Precision, W: Weights, tcfg: dict, audio, video, draws: Draws,
                     frame_mask: Optional[torch.Tensor] = None, pre: str = "video_model"):
    """The AV-HuBERT encoder: ``audio`` [B, T, 104] stacked log-fbank
    features and/or ``video`` [B, T, H, W] normalised lip frames -> [B, T,
    hidden]. Each stream through its front end (the ResNet and a
    projection for the frames, a projection for the features; their
    gradient scaled by ``feature_grad_mult``), scaled by its presence
    (training: with ``modality_dropout``, one draw drops a stream and a
    second picks which), fused (``concat``, or the one stream given), then
    ``layer_norm``, ``post_extract_proj`` and the transformer. In training
    (``draws.train``): BatchNorm on the batch's statistics, dropout after
    the front end and the positional conv, in every block (attention
    weights, residuals, the FFN's activation) and LayerDrop.
    ``frame_mask`` [B, T] (True = a frame) zeroes padded frames and masks
    them as keys outside training."""
    train = draws.train
    dev = (audio if audio is not None else video).device
    b = (audio if audio is not None else video).shape[0]
    keep_a = keep_v = None
    if train and tcfg.get("modality_dropout", 0.0) > 0.0:
        drop_one = draws.scalar(dev) < tcfg["modality_dropout"]
        drop_audio = draws.scalar(dev) < tcfg["audio_dropout"]
        keep_a = torch.where(drop_one & drop_audio, 0.0, 1.0).expand(b)
        keep_v = torch.where(drop_one & ~drop_audio, 0.0, 1.0).expand(b)
    mult = tcfg.get("feature_grad_mult", 1.0)
    feats = []
    if audio is not None:
        f = linear(P, _GradScale.apply(audio, mult), W, f"{pre}.feature_extractor_audio.proj")
        feats.append(f if keep_a is None else f * keep_a[:, None, None])
    if video is not None:
        fe = f"{pre}.feature_extractor_video"
        r = _GradScale.apply(resnet(P, W, f"{fe}.resnet", video, batch_stats=train), mult)
        f = linear(P, r, W, f"{fe}.proj")
        feats.append(f if keep_v is None else f * keep_v[:, None, None])
    t = min(f.shape[1] for f in feats)
    x = torch.cat([f[:, :t] for f in feats], dim=-1)
    x = linear(P, layer_norm(x, W, f"{pre}.layer_norm"), W, f"{pre}.post_extract_proj")
    x = draws.drop(x, tcfg["dropout_input"])
    lengths = None
    if frame_mask is not None:
        frame_mask = frame_mask[:, :t]
        x = x * frame_mask[..., None].to(x.dtype)
        lengths = frame_mask.sum(dim=-1)
    enc = f"{pre}.encoder"
    v, g = W[f"{enc}.pos_conv.0.weight_v"], W[f"{enc}.pos_conv.0.weight_g"]
    kernel = v * torch.rsqrt(v.square().sum(dim=(1, 2), keepdim=True) + 1e-12) * g
    k = tcfg["conv_pos"]
    pos = conv1d(P, x.transpose(1, 2), kernel, W[f"{enc}.pos_conv.0.bias"], padding=k // 2,
                 groups=tcfg["conv_pos_groups"])
    if k % 2 == 0:
        pos = pos[..., :-1]
    x = x + F.gelu(pos).transpose(1, 2)
    x = draws.drop(x, tcfg["hidden_dropout"])
    heads = tcfg["num_attention_heads"]
    names = ("q_proj", "k_proj", "v_proj", "out_proj")
    for i in range(tcfg["num_hidden_layers"]):
        lp = f"{enc}.layers.{i}"
        h = layer_norm(x, W, f"{lp}.self_attn_layer_norm")
        if train:
            a = mha(P, h, h, W, f"{lp}.self_attn", heads, names=names, draws=draws,
                    drop_rate=tcfg["attention_dropout"])
        else:
            a = mha(P, h, h, W, f"{lp}.self_attn", heads, names=names, key_lengths=lengths)
        out = x + draws.drop(a, tcfg["hidden_dropout"])
        h = F.gelu(linear(P, layer_norm(out, W, f"{lp}.final_layer_norm"), W, f"{lp}.fc1"))
        h = linear(P, draws.drop(h, tcfg["activation_dropout"]), W, f"{lp}.fc2")
        out = out + draws.drop(h, tcfg["hidden_dropout"])
        if train and tcfg["layerdrop"] > 0.0:
            out = torch.where(draws.scalar(x.device) < 1.0 - tcfg["layerdrop"], out, x)
        x = out
    return layer_norm(x, W, f"{enc}.layer_norm")


def video_tower(P: Precision, W: Weights, tcfg: dict, video, draws: Draws,
                frame_mask: Optional[torch.Tensor] = None, pre: str = "video_model"):
    """Whisper-Flamingo's video stream: the AV-HuBERT encoder on the lip
    frames alone."""
    return avhubert_encoder(P, W, tcfg, None, video, draws, frame_mask, pre)


# ------------------------------------------------------------- the model


def forward(P: Precision, W: Weights, cfg: dict, mel, tokens, video, draws: Draws,
            frame_mask=None, enc_grad: bool = False):
    """Teacher-forced logits of Whisper-Flamingo: ``mel`` [B, n_mels, T],
    ``tokens`` [B, L], ``video`` [B, T_v, H, W] normalised lip frames. The
    encoder and the tower run without gradients unless ``enc_grad`` (their
    weights are frozen in the Flamingo regime)."""
    w = cfg["whisper"]
    rate = cfg["train"]["dropout_rate"] if draws.train else 0.0
    with torch.set_grad_enabled(enc_grad and torch.is_grad_enabled()):
        feats = whisper_encoder(P, W, w, mel, draws, rate)
        v = video_tower(P, W, cfg["video_tower"], video, draws, frame_mask)
    xv = linear(P, v, W, "video_projection")
    return whisper_decoder(P, W, w, tokens, feats, xv, draws, rate)
