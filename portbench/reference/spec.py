"""The tensors of Whisper-Flamingo by state-dict name, with their shapes
and how the benchmark draws them (:mod:`portbench.weights`).

Kinds: ``fan_in`` N(0, 1/fan_in) (projections, convolutions, the token
embedding over its width), ``bias`` N(0, 0.02^2), ``scale`` 1 + N(0,
0.05^2) (layer and batch norm scales, the weight-norm factors), ``pos``
N(0, 0.01^2) (the decoder's learned positions), ``gate`` the constant
``cfg["gate"]`` (a trained model's gates are open; at 0 the gated
sublayers would do nothing), ``prelu`` 0.25, ``mean`` N(0, 0.05^2)
(BatchNorm running means), ``var`` 1 + U[-0.1, 0.1) (running variances),
``sinusoid`` Whisper's fixed encoder positions, ``uniform`` U[0, 1).
"""

from __future__ import annotations

from typing import List, Tuple

Spec = List[Tuple[str, Tuple[int, ...], str]]


def _linear(out: list, name: str, d_in: int, d_out: int, bias: bool = True) -> None:
    out.append((f"{name}.weight", (d_out, d_in), "fan_in"))
    if bias:
        out.append((f"{name}.bias", (d_out,), "bias"))


def _norm(out: list, name: str, d: int) -> None:
    out.append((f"{name}.weight", (d,), "scale"))
    out.append((f"{name}.bias", (d,), "bias"))


def _mha(out: list, name: str, d: int, d_kv: int, names=("query", "key", "value", "out"),
         key_bias: bool = False) -> None:
    _linear(out, f"{name}.{names[0]}", d, d)
    _linear(out, f"{name}.{names[1]}", d_kv, d, bias=key_bias)
    _linear(out, f"{name}.{names[2]}", d_kv, d)
    _linear(out, f"{name}.{names[3]}", d, d)


def _bn(out: list, name: str, c: int) -> None:
    _norm(out, name, c)
    out.append((f"{name}.running_mean", (c,), "mean"))
    out.append((f"{name}.running_var", (c,), "var"))


def whisper_flamingo(cfg: dict) -> Spec:
    w, t = cfg["whisper"], cfg["video_tower"]
    out: Spec = []
    d, n_mels = w["n_audio_state"], w["n_mels"]
    out.append(("encoder.conv1.weight", (d, n_mels, 3), "fan_in"))
    out.append(("encoder.conv1.bias", (d,), "bias"))
    out.append(("encoder.conv2.weight", (d, d, 3), "fan_in"))
    out.append(("encoder.conv2.bias", (d,), "bias"))
    out.append(("encoder.positional_embedding", (w["n_audio_ctx"], d), "sinusoid"))
    for i in range(w["n_audio_layer"]):
        pre = f"encoder.blocks.{i}"
        _mha(out, f"{pre}.attn", d, d)
        _norm(out, f"{pre}.attn_ln", d)
        _linear(out, f"{pre}.mlp.0", d, 4 * d)
        _linear(out, f"{pre}.mlp.2", 4 * d, d)
        _norm(out, f"{pre}.mlp_ln", d)
    _norm(out, "encoder.ln_post", d)
    d = w["n_text_state"]
    out.append(("decoder.token_embedding.weight", (w["n_vocab"], d), "fan_in"))
    out.append(("decoder.positional_embedding", (w["n_text_ctx"], d), "pos"))
    for i in range(w["n_text_layer"]):
        pre = f"decoder.blocks.{i}"
        _mha(out, f"{pre}.attn", d, d)
        _norm(out, f"{pre}.attn_ln", d)
        _mha(out, f"{pre}.cross_attn", d, w["n_audio_state"])
        _norm(out, f"{pre}.cross_attn_ln", d)
        _mha(out, f"{pre}.x_attn", d, d)
        _norm(out, f"{pre}.x_attn_ln", d)
        out.append((f"{pre}.x_attn_gate", (1,), "gate"))
        _linear(out, f"{pre}.x_mlp.0", d, 4 * d)
        _linear(out, f"{pre}.x_mlp.2", 4 * d, d)
        _norm(out, f"{pre}.x_mlp_ln", d)
        out.append((f"{pre}.x_mlp_gate", (1,), "gate"))
        _linear(out, f"{pre}.mlp.0", d, 4 * d)
        _linear(out, f"{pre}.mlp.2", 4 * d, d)
        _norm(out, f"{pre}.mlp_ln", d)
    _norm(out, "decoder.ln", d)
    h = t["hidden_size"]
    vm, fe = "video_model", "video_model.feature_extractor_video"
    c0, bc = t["visual_frontend_channels"], t["visual_backbone_channels"]
    out.append((f"{vm}.mask_emb", (h,), "uniform"))
    out.append((f"{fe}.resnet.frontend3D.0.weight", (c0, 1, 5, 7, 7), "fan_in"))
    _bn(out, f"{fe}.resnet.frontend3D.1", c0)
    out.append((f"{fe}.resnet.frontend3D.2.weight", (c0,), "prelu"))
    planes, c_in = (bc // 8, bc // 4, bc // 2, bc), c0
    for stage, width in enumerate(planes, start=1):
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
    _norm(out, f"{vm}.layer_norm", h)
    _linear(out, f"{vm}.post_extract_proj", h, h)
    enc = f"{vm}.encoder"
    out.append((f"{enc}.pos_conv.0.weight_g", (h, 1, 1), "scale"))
    out.append((f"{enc}.pos_conv.0.weight_v", (h, h // t["conv_pos_groups"], t["conv_pos"]),
                "fan_in"))
    out.append((f"{enc}.pos_conv.0.bias", (h,), "bias"))
    for i in range(t["num_hidden_layers"]):
        pre = f"{enc}.layers.{i}"
        _mha(out, f"{pre}.self_attn", h, h, names=("q_proj", "k_proj", "v_proj", "out_proj"),
             key_bias=True)
        _norm(out, f"{pre}.self_attn_layer_norm", h)
        _linear(out, f"{pre}.fc1", h, t["intermediate_size"])
        _linear(out, f"{pre}.fc2", t["intermediate_size"], h)
        _norm(out, f"{pre}.final_layer_norm", h)
    _norm(out, f"{enc}.layer_norm", h)
    _linear(out, "video_projection", h, d)
    return out


def trained(name: str) -> bool:
    """The Flamingo regime's trained tensors: the gated sublayers, their
    norms and gates, and the video projection; the video tower is frozen."""
    return ("x_attn" in name or "x_mlp" in name or "video_projection" in name) \
        and "video_model" not in name
