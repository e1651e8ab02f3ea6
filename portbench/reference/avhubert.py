"""AV-HuBERT large with its sequence-to-sequence head, in plain PyTorch
(arXiv:2201.02184, facebookresearch/av_hubert ``hubert_asr.py``): the
audio-visual encoder of :func:`~portbench.reference.whisper_flamingo.avhubert_encoder`
under ``encoder.w2v_model``, then fairseq's pre-norm transformer decoder
(``decoder``): token embeddings times sqrt(d), fairseq's sinusoid
positions (rows from ``pad + 1``), dropout, blocks of causal
self-attention over the non-pad tokens, cross-attention onto the encoder
output, and an FFN, each with dropout on its output (the FFN also on its
activation), decoder LayerDrop, a final norm and logits tied to the
embedding; the loss is label-smoothed cross-entropy over the labels that
are not -100.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import whisper_flamingo as wf
from portbench.reference.precision import Precision
from portbench.reference.spec import Spec, _bn, _linear, _mha, _norm

NAMES = ("q_proj", "k_proj", "v_proj", "out_proj")


def fairseq_sinusoids(length: int, d: int, pad: int) -> torch.Tensor:
    half = d // 2
    inv = np.exp(np.arange(half) * -(np.log(10000.0) / (half - 1)))
    pos = np.arange(pad + 1, length + pad + 1)[:, None] * inv[None, :]
    table = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    if d % 2:
        table = np.concatenate([table, np.zeros((length, 1))], axis=1)
    return torch.from_numpy(table.astype(np.float32))


def decoder(P: Precision, W: Dict[str, torch.Tensor], c: dict, tokens, enc, enc_valid,
            draws: wf.Draws):
    d = c["decoder_hidden_size"]
    emb = W["decoder.embed_tokens.weight"]
    x = emb[tokens] * math.sqrt(d)
    x = x + fairseq_sinusoids(tokens.shape[1], d, c["pad_token_id"]).to(x.device)
    x = draws.drop(x, c["decoder_dropout"])
    lengths = (tokens != c["pad_token_id"]).sum(dim=-1)
    enc_len = enc_valid.sum(dim=-1)
    heads = c["decoder_attention_heads"]
    for i in range(c["decoder_layers"]):
        pre = f"decoder.layers.{i}"
        h = wf.layer_norm(x, W, f"{pre}.self_attn_layer_norm")
        a = wf.mha(P, h, h, W, f"{pre}.self_attn", heads, names=NAMES, causal=True,
                   key_lengths=lengths, draws=draws, drop_rate=c["decoder_attention_dropout"])
        out = x + draws.drop(a, c["decoder_dropout"])
        h = wf.layer_norm(out, W, f"{pre}.encoder_attn_layer_norm")
        a = wf.mha(P, h, enc, W, f"{pre}.encoder_attn", heads, names=NAMES, key_lengths=enc_len,
                   draws=draws, drop_rate=c["decoder_attention_dropout"])
        out = out + draws.drop(a, c["decoder_dropout"])
        h = F.gelu(wf.linear(P, wf.layer_norm(out, W, f"{pre}.final_layer_norm"), W,
                             f"{pre}.fc1"))
        h = wf.linear(P, draws.drop(h, c["decoder_activation_dropout"]), W, f"{pre}.fc2")
        out = out + draws.drop(h, c["decoder_dropout"])
        if draws.train and c["decoder_layerdrop"] > 0.0:
            out = torch.where(draws.scalar(x.device) < 1.0 - c["decoder_layerdrop"], out, x)
        x = out
    x = wf.layer_norm(x, W, "decoder.layer_norm")
    return P.mm(x, emb)


def seq2seq_loss(P: Precision, W, c: dict, mb: Dict[str, torch.Tensor], generator,
                 keep_rows=None):
    """Label-smoothed CE of one micro-batch (``audio`` [B, T, 104],
    ``video`` [B, T, H, W], ``valid`` [B, T], ``dec`` and ``labels`` [B, L])
    with every training draw from ``generator``."""
    draws = wf.Draws(generator, train=True)
    audio, video, valid, dec, labels = (mb[k] for k in ("audio", "video", "valid", "dec",
                                                        "labels"))
    if keep_rows is not None:
        audio, video, valid, dec, labels = (t[:keep_rows] for t in (audio, video, valid, dec,
                                                                     labels))
    enc = wf.avhubert_encoder(P, W, c, audio, video, draws, valid, pre="encoder.w2v_model")
    logits = decoder(P, W, c, dec, enc, valid[:, : enc.shape[1]], draws)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ok = labels != -100
    nll = -logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    eps = c["label_smoothing"]
    nll = (1.0 - eps) * nll + eps * (-logp.mean(dim=-1))
    return (nll * ok).sum() / ok.sum().clamp(min=1)


def spec(c: dict) -> Spec:
    """The state dict of AV-HuBERT with the seq2seq head (see
    :mod:`portbench.reference.spec` for the kinds)."""
    out: Spec = []
    h = c["hidden_size"]
    w2v = "encoder.w2v_model"
    fe = f"{w2v}.feature_extractor_video"
    c0, bc = c["visual_frontend_channels"], c["visual_backbone_channels"]
    out.append((f"{w2v}.mask_emb", (h,), "uniform"))
    _linear(out, f"{w2v}.feature_extractor_audio.proj", c["audio_feat_dim"], h)
    out.append((f"{fe}.resnet.frontend3D.0.weight", (c0, 1, 5, 7, 7), "fan_in"))
    _bn(out, f"{fe}.resnet.frontend3D.1", c0)
    out.append((f"{fe}.resnet.frontend3D.2.weight", (c0,), "prelu"))
    c_in = c0
    for stage, width in enumerate((bc // 8, bc // 4, bc // 2, bc), start=1):
        for blk in range(2):
            pre = f"{fe}.resnet.trunk.layer{stage}.{blk}"
            out.append((f"{pre}.conv1.weight", (width, c_in, 3, 3), "fan_in"))
            _bn(out, f"{pre}.bn1", width)
            out.append((f"{pre}.relu1.weight", (width,), "prelu"))
            out.append((f"{pre}.conv2.weight", (width, width, 3, 3), "fan_in"))
            _bn(out, f"{pre}.bn2", width)
            out.append((f"{pre}.relu2.weight", (width,), "prelu"))
            if blk == 0 and (stage > 1 or c_in != width):
                out.append((f"{pre}.downsample.0.weight", (width, c_in, 1, 1), "fan_in"))
                _bn(out, f"{pre}.downsample.1", width)
            c_in = width
    _linear(out, f"{fe}.proj", bc, h)
    _norm(out, f"{w2v}.layer_norm", 2 * h)
    _linear(out, f"{w2v}.post_extract_proj", 2 * h, h)
    enc = f"{w2v}.encoder"
    out.append((f"{enc}.pos_conv.0.weight_g", (h, 1, 1), "scale"))
    out.append((f"{enc}.pos_conv.0.weight_v", (h, h // c["conv_pos_groups"], c["conv_pos"]),
                "fan_in"))
    out.append((f"{enc}.pos_conv.0.bias", (h,), "bias"))
    for i in range(c["num_hidden_layers"]):
        pre = f"{enc}.layers.{i}"
        _mha(out, f"{pre}.self_attn", h, h, names=NAMES, key_bias=True)
        _norm(out, f"{pre}.self_attn_layer_norm", h)
        _linear(out, f"{pre}.fc1", h, c["intermediate_size"])
        _linear(out, f"{pre}.fc2", c["intermediate_size"], h)
        _norm(out, f"{pre}.final_layer_norm", h)
    _norm(out, f"{enc}.layer_norm", h)
    d = c["decoder_hidden_size"]
    out.append(("decoder.embed_tokens.weight", (c["vocab_size"], d), "fan_in"))
    for i in range(c["decoder_layers"]):
        pre = f"decoder.layers.{i}"
        _mha(out, f"{pre}.self_attn", d, d, names=NAMES, key_bias=True)
        _norm(out, f"{pre}.self_attn_layer_norm", d)
        _mha(out, f"{pre}.encoder_attn", d, h, names=NAMES, key_bias=True)
        _norm(out, f"{pre}.encoder_attn_layer_norm", d)
        _linear(out, f"{pre}.fc1", d, c["decoder_ffn_dim"])
        _linear(out, f"{pre}.fc2", c["decoder_ffn_dim"], d)
        _norm(out, f"{pre}.final_layer_norm", d)
    _norm(out, "decoder.layer_norm", d)
    return out
