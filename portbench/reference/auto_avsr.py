"""Auto-AVSR's audio-visual model in plain PyTorch (arXiv:2303.14307,
mpc001/auto_avsr ``audiovisual_backbone``, whose modules are ESPnet's),
written from its equations, fp32:

* each encoder: the frontend (the lips: Conv3D 5 x 7 x 7 stride 1 x 2 x
  2, BatchNorm, swish, a 3 x 3 max pool and a ResNet-18 trunk of swish
  basic blocks, a mean over each frame; the audio: PCM cut to whole
  640-sample frames, Conv1D k 80 stride 4 pad 38, BatchNorm, swish, four
  stages of two swish basic blocks at strides 1, 2, 2, 2, AvgPool1D k 21
  stride 20 pad 1), ``x = Linear(frontend) * sqrt(adim)``, dropout on x,
  then on the relative positional table ``pe`` (2T - 1 rows for the
  relative positions T - 1 ... -(T - 1), sin in the even columns, cos in
  the odd ones), ``elayers`` macaron Conformer blocks and a final norm;
* a block: ``x += drop(FFN1(LN x)) / 2``; ``x += drop(MHSA_rel(LN x,
  pe))``; ``x += drop(Conv(LN x))``; ``x += drop(FFN2(LN x)) / 2``; ``x =
  LN x``; ``FFN = W2 drop(swish(W1 .))``; MHSA_rel: scores ``((q + u)
  k^T + rel_shift((q + v) p^T)) / sqrt(D)`` with ``p = W_pos pe``, a
  masked softmax, dropout on the weights, the weighted sum and
  ``linear_out``; ``rel_shift`` pads a zero column, views [T, 2T] as [2T,
  T], drops the first row and keeps T columns; Conv: pointwise Conv1D to
  2C, GLU, depthwise Conv1D (k, pad (k - 1) / 2, bias), BatchNorm, swish,
  pointwise Conv1D;
* the fusion ``fc2(relu(BN(fc1 [video; audio])))``, the CTC head on the
  fused sequence after dropout, the decoder (embeddings times sqrt(ddim)
  plus interleaved sinusoids, dropout, pre-norm blocks of causal
  self-attention, source attention and a ReLU FFN, each output dropped
  before its residual, a final norm, an untied output layer with bias);
* the loss ``mtlalpha x CTC + (1 - mtlalpha) x KL``: the CTC negative
  log-likelihood by the forward recursion over the blank-extended labels
  (infinite losses zeroed), summed over the batch and divided by B; the
  KL divergence of the softmax from the smoothed target (``1 - lsm`` on the
  label, ``lsm / (V - 1)`` elsewhere), summed over the labels that are not
  -100 and divided by B.

Each encoder masks its own stream's padding (the lips' by
``video_lengths``, the audio's by ``audio_lengths`` in whole 640-sample
frames); the CTC's lengths and the decoder's memory mask are the video's,
as auto_avsr's E2E. Layer norms take eps 1e-12 (ESPnet's). In training BatchNorm normalises
by the batch's statistics and every dropout draws from one generator
(:class:`~portbench.reference.whisper_flamingo.Draws`) in this order: the
lips' encoder, the audio's, the CTC input, the decoder; within an
encoder the embedding, the positions, then each block's macaron FFN
activation and output, attention weights and output, conv output, FFN
activation and output; within the decoder the embedding, then each
block's self-attention weights and output, source-attention weights and
output, FFN activation and output. Departures from auto_avsr: none
beyond the random weights (:func:`spec`) and the labels' padding (-100,
not -1); the frontends run before the Conformer stacks, which changes no
draw (the frontends draw none).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from portbench.reference import whisper_flamingo as wf
from portbench.reference.precision import Precision
from portbench.reference.spec import Spec, _bn, _linear, _mha, _norm

EPS = 1e-12
FRAME = 640
BLANK = 0
NAMES = ("linear_q", "linear_k", "linear_v", "linear_out")
NEG = -1e30  # log of an unreachable CTC state (finite, so its gradient is 0, not NaN)


def layer_norm(x, W, name):
    return wf.layer_norm(x, W, name, eps=EPS)


def rel_positions(t: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(t - 1, -t, -1, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d))
    pe = torch.zeros(2 * t - 1, d, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def abs_positions(length: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d))
    pe = torch.zeros(length, d, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    b, h, t, n = x.shape
    padded = torch.cat([torch.zeros(b, h, t, 1, device=x.device, dtype=x.dtype), x], dim=-1)
    return padded.view(b, h, n + 1, t)[:, :, 1:].reshape(b, h, t, n)[..., : n // 2 + 1]


def rel_attention(P: Precision, x, pe, W, pre: str, heads: int, valid, draws: wf.Draws,
                  rate: float):
    b, t, width = x.shape
    d = width // heads

    def split(y):
        return y.view(b, -1, heads, d).transpose(1, 2)

    q, k, v = (split(wf.linear(P, x, W, f"{pre}.{n}")) for n in NAMES[:3])
    p = P.mm(pe, W[f"{pre}.linear_pos.weight"]).view(-1, heads, d).transpose(0, 1)
    ac = P.bmm(q + W[f"{pre}.pos_bias_u"][:, None], k.transpose(-1, -2))
    bd = P.bmm(q + W[f"{pre}.pos_bias_v"][:, None], p.transpose(-1, -2)[None])
    scores = (ac + rel_shift(bd)) / math.sqrt(d)
    keep = valid[:, None, None, :]
    scores = scores.masked_fill(~keep, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).masked_fill(~keep, 0.0)
    out = P.bmm(draws.drop(probs, rate), v).transpose(1, 2).reshape(b, t, width)
    return wf.linear(P, out, W, f"{pre}.linear_out")


def ffn(P: Precision, x, W, pre: str, act, draws: wf.Draws, rate: float):
    h = draws.drop(act(wf.linear(P, x, W, f"{pre}.w_1")), rate)
    return wf.linear(P, h, W, f"{pre}.w_2")


def conv_module(P: Precision, x, W, pre: str, kernel: int, batch_stats: bool):
    h = x.transpose(1, 2)
    h = wf.conv1d(P, h, W[f"{pre}.pointwise_conv1.weight"], W[f"{pre}.pointwise_conv1.bias"])
    h = F.glu(h, dim=1)
    h = wf.conv1d(P, h, W[f"{pre}.depthwise_conv.weight"], W[f"{pre}.depthwise_conv.bias"],
                  padding=(kernel - 1) // 2, groups=h.shape[1])
    h = F.silu(wf.batch_norm(h, W, f"{pre}.norm", batch_stats))
    h = wf.conv1d(P, h, W[f"{pre}.pointwise_conv2.weight"], W[f"{pre}.pointwise_conv2.bias"])
    return h.transpose(1, 2)


def block(P: Precision, x, pe, W, pre: str, c: dict, valid, draws: wf.Draws):
    rate = c["dropout_rate"]
    x = x + 0.5 * draws.drop(ffn(P, layer_norm(x, W, f"{pre}.norm_ff_macaron"), W,
                                 f"{pre}.feed_forward_macaron", F.silu, draws, rate), rate)
    a = rel_attention(P, layer_norm(x, W, f"{pre}.norm_mha"), pe, W, f"{pre}.self_attn",
                      c["aheads"], valid, draws, c["transformer_attn_dropout_rate"])
    x = x + draws.drop(a, rate)
    x = x + draws.drop(conv_module(P, layer_norm(x, W, f"{pre}.norm_conv"), W,
                                   f"{pre}.conv_module", c["cnn_module_kernel"], draws.train),
                       rate)
    x = x + 0.5 * draws.drop(ffn(P, layer_norm(x, W, f"{pre}.norm_ff"), W,
                                 f"{pre}.feed_forward", F.silu, draws, rate), rate)
    return layer_norm(x, W, f"{pre}.norm_final")


def _basic_block(P, W, name, x, stride, batch_stats, conv):
    out = conv(P.op(x), P.op(W[f"{name}.conv1.weight"]), None, stride=stride, padding=1)
    out = F.silu(wf.batch_norm(out, W, f"{name}.bn1", batch_stats))
    out = conv(P.op(out), P.op(W[f"{name}.conv2.weight"]), None, padding=1)
    out = wf.batch_norm(out, W, f"{name}.bn2", batch_stats)
    if f"{name}.downsample.0.weight" in W:
        x = wf.batch_norm(conv(P.op(x), P.op(W[f"{name}.downsample.0.weight"]), None,
                               stride=stride), W, f"{name}.downsample.1", batch_stats)
    return F.silu(out + x)


def _stages(P, W, pre, x, batch_stats, conv):
    for stage in range(1, 5):
        for blk in range(2):
            stride = 2 if stage > 1 and blk == 0 else 1
            x = _basic_block(P, W, f"{pre}.layer{stage}.{blk}", x, stride, batch_stats, conv)
    return x


def lip_resnet(P: Precision, W, pre: str, video, batch_stats: bool):
    """Lip frames [B, T, H, W] -> [B, T, 512]."""
    b, t = video.shape[:2]
    x = F.conv3d(P.op(video[:, None]), P.op(W[f"{pre}.frontend3D.0.weight"]), None,
                 stride=(1, 2, 2), padding=(2, 3, 3))
    x = F.silu(wf.batch_norm(x, W, f"{pre}.frontend3D.1", batch_stats))
    x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    x = x.transpose(1, 2).reshape(b * t, x.shape[1], x.shape[3], x.shape[4])
    x = _stages(P, W, f"{pre}.trunk", x, batch_stats, F.conv2d)
    return x.mean(dim=(2, 3)).view(b, t, -1)


def audio_resnet(P: Precision, W, pre: str, pcm, batch_stats: bool):
    """PCM [B, S] -> [B, S // 640, 512]."""
    s = pcm.shape[1] // FRAME * FRAME
    x = F.conv1d(P.op(pcm[:, None, :s]), P.op(W[f"{pre}.trunk.conv1.weight"]), None, stride=4,
                 padding=38)
    x = F.silu(wf.batch_norm(x, W, f"{pre}.trunk.bn1", batch_stats))
    x = _stages(P, W, f"{pre}.trunk", x, batch_stats, F.conv1d)
    return F.avg_pool1d(x, kernel_size=21, stride=20, padding=1).transpose(1, 2)


def encoder(P: Precision, W, c: dict, pre: str, feats, valid, draws: wf.Draws):
    """Frontend features [B, T, C] -> [B, T, adim]."""
    d = c["adim"]
    x = draws.drop(wf.linear(P, feats, W, f"{pre}.embed.0") * math.sqrt(d), c["dropout_rate"])
    pe = draws.drop(rel_positions(x.shape[1], d, x.device)[None], c["dropout_rate"])[0]
    for i in range(c["elayers"]):
        x = block(P, x, pe, W, f"{pre}.encoders.{i}", c, valid, draws)
    return layer_norm(x, W, f"{pre}.after_norm")


def decoder(P: Precision, W, c: dict, tokens, memory, valid, draws: wf.Draws):
    d, rate = c["ddim"], c["dropout_rate"]
    attn_rate = c["transformer_attn_dropout_rate"]
    x = W["decoder.embed.0.weight"][tokens] * math.sqrt(d)
    x = draws.drop(x + abs_positions(tokens.shape[1], d, x.device), rate)
    lengths = valid.sum(dim=-1)
    for i in range(c["dlayers"]):
        pre = f"decoder.decoders.{i}"
        h = layer_norm(x, W, f"{pre}.norm1")
        x = x + draws.drop(wf.mha(P, h, h, W, f"{pre}.self_attn", c["dheads"], names=NAMES,
                                  causal=True, draws=draws, drop_rate=attn_rate), rate)
        h = layer_norm(x, W, f"{pre}.norm2")
        x = x + draws.drop(wf.mha(P, h, memory, W, f"{pre}.src_attn", c["dheads"], names=NAMES,
                                  key_lengths=lengths, draws=draws, drop_rate=attn_rate), rate)
        h = layer_norm(x, W, f"{pre}.norm3")
        x = x + draws.drop(ffn(P, h, W, f"{pre}.feed_forward", F.relu, draws, rate), rate)
    return wf.linear(P, layer_norm(x, W, "decoder.after_norm"), W, "decoder.output_layer")


def ctc_nll(logp, lengths, targets, target_lengths, blank: int) -> torch.Tensor:
    """Per row, -log of the summed probability of every CTC alignment of
    ``targets`` [B, L] (up to ``target_lengths``) over the first
    ``lengths`` frames of ``logp`` [B, T, V]: the forward recursion over
    the blank-extended labels."""
    b, t, _ = logp.shape
    ext = torch.full((b, 2 * targets.shape[1] + 1), blank, dtype=torch.long, device=logp.device)
    ext[:, 1::2] = targets
    skip = torch.zeros_like(ext, dtype=torch.bool)
    skip[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    lp = logp.gather(2, ext[:, None, :].expand(b, t, ext.shape[1]))
    pad = torch.full((b, 1), NEG, device=logp.device)
    alpha = torch.cat([lp[:, 0, :2], torch.full((b, ext.shape[1] - 2), NEG,
                                                 device=logp.device)], dim=1)
    for i in range(1, t):
        one = torch.cat([pad, alpha[:, :-1]], dim=1)
        two = torch.where(skip, torch.cat([pad, pad, alpha[:, :-2]], dim=1), NEG)
        new = torch.logsumexp(torch.stack([alpha, one, two]), dim=0) + lp[:, i]
        alpha = torch.where((i < lengths)[:, None], new, alpha)
    end = 2 * target_lengths[:, None]
    ends = torch.cat([alpha.gather(1, end), alpha.gather(1, end - 1)], dim=1)
    return -torch.logsumexp(ends, dim=1)


def ctc_loss(ctc_logits, lengths, targets, target_lengths) -> torch.Tensor:
    nll = ctc_nll(torch.log_softmax(ctc_logits, dim=-1), lengths, targets, target_lengths,
                  BLANK)
    nll = torch.where(nll > -0.5 * NEG, torch.zeros_like(nll), nll)  # infeasible: zeroed
    return nll.sum() / ctc_logits.shape[0]


def kl_smoothing(logits, labels, smoothing: float) -> torch.Tensor:
    b, v = labels.shape[0], logits.shape[-1]
    x = logits.reshape(-1, v)
    target = labels.reshape(-1)
    ignore = target == -100
    true = torch.full_like(x, smoothing / (v - 1))
    true.scatter_(1, target.masked_fill(ignore, 0)[:, None], 1.0 - smoothing)
    kl = F.kl_div(torch.log_softmax(x, dim=-1), true, reduction="none")
    return kl.masked_fill(ignore[:, None], 0.0).sum() / b


def joint_loss(P: Precision, W, c: dict, mb: Dict[str, torch.Tensor], generator,
               keep_rows: Optional[int] = None, parts: bool = False):
    """The joint loss of one micro-batch (``video`` [B, T, H, W],
    ``audio`` [B, S], ``video_lengths``, ``audio_lengths``, ``targets``,
    ``target_lengths``, ``dec``, ``labels``) with every training draw from
    ``generator``; with ``parts`` also ``(loss_ctc, loss_att)``."""
    draws = wf.Draws(generator, train=True)
    mb = {k: v[:keep_rows] for k, v in mb.items()} if keep_rows is not None else mb
    fv = lip_resnet(P, W, "encoder.frontend", mb["video"], True)
    fa = audio_resnet(P, W, "aux_encoder.frontend", mb["audio"], True)
    t = min(fv.shape[1], fa.shape[1])
    frames = torch.arange(t, device=fv.device)[None, :]
    valid = frames < mb["video_lengths"][:, None]
    a_valid = frames < (mb["audio_lengths"] // FRAME)[:, None]
    v = encoder(P, W, c, "encoder", fv[:, :t], valid, draws)
    a = encoder(P, W, c, "aux_encoder", fa[:, :t], a_valid, draws)
    h = wf.linear(P, torch.cat([v, a], dim=-1), W, "fusion.fc1")
    x = wf.linear(P, F.relu(wf.batch_norm(h.transpose(1, 2), W, "fusion.bn1", True)
                            .transpose(1, 2)), W, "fusion.fc2")
    ctc_logits = wf.linear(P, draws.drop(x, c["dropout_rate"]), W, "ctc.ctc_lo")
    logits = decoder(P, W, c, mb["dec"], x, valid, draws)
    loss_ctc = ctc_loss(ctc_logits, valid.sum(dim=-1), mb["targets"], mb["target_lengths"])
    loss_att = kl_smoothing(logits, mb["labels"], c["lsm_weight"])
    loss = c["mtlalpha"] * loss_ctc + (1.0 - c["mtlalpha"]) * loss_att
    return (loss, loss_ctc, loss_att) if parts else loss


def spec(c: dict) -> Spec:
    """The state dict of the audio-visual model by ESPnet's names (see
    :mod:`portbench.reference.spec` for the kinds)."""
    out: Spec = []
    d, heads = c["adim"], c["aheads"]
    for pre, modality in (("encoder", "video"), ("aux_encoder", "audio")):
        fe = f"{pre}.frontend"
        if modality == "video":
            c0, bc = c["visual_frontend_channels"], c["visual_backbone_channels"]
            out.append((f"{fe}.frontend3D.0.weight", (c0, 1, 5, 7, 7), "fan_in"))
            _bn(out, f"{fe}.frontend3D.1", c0)
            kernel = (3, 3)
        else:
            bc = c["audio_backbone_channels"]
            c0 = max(bc // 8, 8)
            out.append((f"{fe}.trunk.conv1.weight", (c0, 1, 80), "fan_in"))
            _bn(out, f"{fe}.trunk.bn1", c0)
            kernel = (3,)
        c_in = c0
        for stage, width in enumerate((max(bc // 8, 8), max(bc // 4, 8), max(bc // 2, 8), bc),
                                      start=1):
            for blk in range(2):
                bp = f"{fe}.trunk.layer{stage}.{blk}"
                out.append((f"{bp}.conv1.weight", (width, c_in) + kernel, "fan_in"))
                _bn(out, f"{bp}.bn1", width)
                out.append((f"{bp}.conv2.weight", (width, width) + kernel, "fan_in"))
                _bn(out, f"{bp}.bn2", width)
                if blk == 0 and (stage > 1 or c_in != width):
                    out.append((f"{bp}.downsample.0.weight", (width, c_in) + (1,) * len(kernel),
                                "fan_in"))
                    _bn(out, f"{bp}.downsample.1", width)
                c_in = width
        _linear(out, f"{pre}.embed.0", bc, d)
        for i in range(c["elayers"]):
            bp = f"{pre}.encoders.{i}"
            for ff in ("feed_forward_macaron", "feed_forward"):
                _linear(out, f"{bp}.{ff}.w_1", d, c["eunits"])
                _linear(out, f"{bp}.{ff}.w_2", c["eunits"], d)
            _mha(out, f"{bp}.self_attn", d, d, names=NAMES, key_bias=True)
            _linear(out, f"{bp}.self_attn.linear_pos", d, d, bias=False)
            out.append((f"{bp}.self_attn.pos_bias_u", (heads, d // heads), "fan_in"))
            out.append((f"{bp}.self_attn.pos_bias_v", (heads, d // heads), "fan_in"))
            cm = f"{bp}.conv_module"
            out.append((f"{cm}.pointwise_conv1.weight", (2 * d, d, 1), "fan_in"))
            out.append((f"{cm}.pointwise_conv1.bias", (2 * d,), "bias"))
            out.append((f"{cm}.depthwise_conv.weight", (d, 1, c["cnn_module_kernel"]), "fan_in"))
            out.append((f"{cm}.depthwise_conv.bias", (d,), "bias"))
            _bn(out, f"{cm}.norm", d)
            out.append((f"{cm}.pointwise_conv2.weight", (d, d, 1), "fan_in"))
            out.append((f"{cm}.pointwise_conv2.bias", (d,), "bias"))
            for norm in ("norm_ff", "norm_mha", "norm_ff_macaron", "norm_conv", "norm_final"):
                _norm(out, f"{bp}.{norm}", d)
        _norm(out, f"{pre}.after_norm", d)
    _linear(out, "fusion.fc1", 2 * d, c["fusion_hdim"])
    _bn(out, "fusion.bn1", c["fusion_hdim"])
    _linear(out, "fusion.fc2", c["fusion_hdim"], d)
    _linear(out, "ctc.ctc_lo", d, c["odim"])
    dd = c["ddim"]
    out.append(("decoder.embed.0.weight", (c["odim"], dd), "fan_in"))
    for i in range(c["dlayers"]):
        bp = f"decoder.decoders.{i}"
        _mha(out, f"{bp}.self_attn", dd, dd, names=NAMES, key_bias=True)
        _mha(out, f"{bp}.src_attn", dd, d, names=NAMES, key_bias=True)
        _linear(out, f"{bp}.feed_forward.w_1", dd, c["dunits"])
        _linear(out, f"{bp}.feed_forward.w_2", c["dunits"], dd)
        for norm in ("norm1", "norm2", "norm3"):
            _norm(out, f"{bp}.{norm}", dd)
    _norm(out, "decoder.after_norm", dd)
    _linear(out, "decoder.output_layer", dd, c["odim"])
    return out
