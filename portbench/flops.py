"""Model operations counted from shapes, and the operations and bytes of
the attention kernels K1 (forward) and K2 (backward) from their launch
shapes.

A product of [m, k] by [k, n] is 2 m k n operations; attention over Tq
queries and Tk keys of H heads of D is 4 Tq Tk H D forward (the scores
and the weighted sum) and 8 Tq Tk H D backward, halved under a causal
mask, over each row's key length when the launch gives lengths. A
backward pass costs twice its forward where the weights take gradients
and once where only the activations do; no rematerialised forward is
counted. Elementwise work, norms and softmax are not counted.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence


def linear(rows: int, d_in: int, d_out: int) -> float:
    return 2.0 * rows * d_in * d_out


def attn(tq: int, tk: int, width: int, causal: bool = False) -> float:
    """Forward operations of attention for one row: width = H * D."""
    return 4.0 * tq * tk * width * (0.5 if causal else 1.0)


def whisper_encoder(w: dict, t_mel: int) -> float:
    d, t = w["n_audio_state"], t_mel // 2
    conv = 2.0 * t_mel * w["n_mels"] * d * 3 + 2.0 * t * d * d * 3
    block = 4 * linear(t, d, d) + 2 * linear(t, d, 4 * d) + attn(t, t, d)
    return conv + w["n_audio_layer"] * block


def resnet_frame(tcfg: dict, h: int) -> float:
    """One lip frame of h x h through the stem (its share of the Conv3D)
    and the ResNet-18 trunk."""
    c0, bc = tcfg["visual_frontend_channels"], tcfg["visual_backbone_channels"]
    s = h // 2
    ops = 2.0 * s * s * c0 * 5 * 7 * 7
    s = (s + 1) // 2
    c_in = c0
    for stage, width in enumerate((bc // 8, bc // 4, bc // 2, bc)):
        for blk in range(2):
            stride = 2 if stage > 0 and blk == 0 else 1
            s_out = (s - 1) // stride + 1
            ops += 2.0 * s_out * s_out * width * c_in * 9 + 2.0 * s_out * s_out * width * width * 9
            if blk == 0 and (stage > 0 or c_in != width):
                ops += 2.0 * s_out * s_out * width * c_in
            c_in, s = width, s_out
    return ops


def video_tower(tcfg: dict, frames: int, h: int) -> float:
    d = tcfg["hidden_size"]
    ops = frames * resnet_frame(tcfg, h)
    ops += linear(frames, tcfg["visual_backbone_channels"], d) + linear(frames, d, d)
    ops += 2.0 * frames * d * (d // tcfg["conv_pos_groups"]) * tcfg["conv_pos"]
    block = 4 * linear(frames, d, d) + 2 * linear(frames, d, tcfg["intermediate_size"])
    return ops + tcfg["num_hidden_layers"] * (block + attn(frames, frames, d))


def decoder_tokens(w: dict, positions: int, keys: int, t_audio: int, t_video: int) -> float:
    """The decoder's operations for ``positions`` new positions attending
    to ``keys`` positions in all (teacher-forced: keys = positions, causal),
    with the cross and gated K/V projections NOT included (see
    :func:`decoder_kv`)."""
    d, v = w["n_text_state"], w["n_vocab"]
    causal = positions == keys
    block = (4 * linear(positions, d, d) + attn(positions, keys, d, causal)  # self
             + 2 * linear(positions, d, d) + attn(positions, t_audio, d)      # cross q, out
             + 2 * linear(positions, d, d) + attn(positions, t_video, d)      # gated q, out
             + 4 * linear(positions, d, 4 * d))                               # x_mlp and mlp
    return w["n_text_layer"] * block + linear(positions, d, v)


def decoder_kv(w: dict, t_audio: int, t_video: int) -> float:
    """The cross-attention and gated K/V projections of every block, and
    the video projection."""
    d = w["n_text_state"]
    return (w["n_text_layer"] * (2 * linear(t_audio, w["n_audio_state"], d)
                                 + 2 * linear(t_video, d, d))
            + linear(t_video, w["video_state"], d))


def transcribe_segment(cfg: dict, t_mel: int, frames: int, crop: int, prompt: int,
                       new_tokens: int) -> float:
    """One segment of greedy AV transcription: both encoders, the cache
    build, the prompt step and ``new_tokens - 1`` cached steps."""
    w, t = cfg["whisper"], cfg["video_tower"]
    ta = t_mel // 2
    ops = whisper_encoder(w, t_mel) + video_tower(t, frames, crop)
    ops += decoder_kv(dict(w, video_state=t["hidden_size"]), ta, frames)
    ops += decoder_tokens(w, prompt, prompt, ta, frames)
    for i in range(1, new_tokens):
        ops += decoder_tokens(w, 1, prompt + i, ta, frames)
    return ops


def flamingo_train_segment(cfg: dict, t_mel: int, frames: int, crop: int,
                           label_len: int) -> float:
    """One segment of a Flamingo fine-tuning micro-step: the frozen
    encoders forward only; the decoder, its K/V projections and the video
    projection forward, then backward to the activations everywhere (1x)
    and to the weights of the gated sublayers and the video projection
    (1x more)."""
    w, t = cfg["whisper"], cfg["video_tower"]
    ta, d = t_mel // 2, w["n_text_state"]
    towers = whisper_encoder(w, t_mel) + video_tower(t, frames, crop)
    kv = decoder_kv(dict(w, video_state=t["hidden_size"]), ta, frames)
    dec = decoder_tokens(w, label_len, label_len, ta, frames)
    gated_w = w["n_text_layer"] * (2 * linear(label_len, d, d) + 2 * linear(frames, d, d)
                                   + 2 * linear(label_len, d, 4 * d)) \
        + linear(frames, t["hidden_size"], d)
    return towers + 2 * (dec + kv) + gated_w


def kernel_launch(kind: str, b: int, h: int, tq: int, tk: int, d: int, itemsize: int,
                  causal: bool, lengths: Optional[Sequence[int]] = None) -> Dict[str, float]:
    """Algorithmic operations and bytes of one K1 ("fwd") or K2 ("bwd")
    launch: operands read once and results written once (K2 also reads O,
    dO and the fp32 row statistics and writes dQ, dK, dV)."""
    keys: Iterable[int] = lengths if lengths is not None else [tk] * b
    per = 4.0 if kind == "fwd" else 8.0
    ops = sum(per * tq * min(int(k), tk) * h * d * (0.5 if causal else 1.0) for k in keys)
    if kind == "fwd":
        elems = b * h * d * (2 * tq + 2 * tk)
        extra = 0
    else:
        elems = b * h * d * (4 * tq + 4 * tk)
        extra = b * h * tq * 4 * 2
    return {"ops": ops, "bytes": elems * itemsize + extra + (4 * b if lengths is not None else 0)}


def avhubert_train_segment(m: dict, frames: int, label_len: int) -> float:
    """One segment of an AV-HuBERT seq2seq training step, every tensor
    trained: the forward (both front ends, the fusion, the encoder, the
    decoder and the tied logits) and a backward of twice that."""
    h, d = m["hidden_size"], m["decoder_hidden_size"]
    fwd = linear(frames, m["audio_feat_dim"], h) + frames * resnet_frame(m, m["image_crop_size"])
    fwd += linear(frames, m["visual_backbone_channels"], h) + linear(frames, 2 * h, h)
    fwd += 2.0 * frames * h * (h // m["conv_pos_groups"]) * m["conv_pos"]
    fwd += m["num_hidden_layers"] * (4 * linear(frames, h, h)
                                      + 2 * linear(frames, h, m["intermediate_size"])
                                      + attn(frames, frames, h))
    layer = (4 * linear(label_len, d, d) + attn(label_len, label_len, d, causal=True)
             + 2 * linear(label_len, d, d) + 2 * linear(frames, h, d) + attn(label_len, frames, d)
             + 2 * linear(label_len, d, m["decoder_ffn_dim"]))
    fwd += m["decoder_layers"] * layer + linear(label_len, d, m["vocab_size"])
    return 3.0 * fwd
