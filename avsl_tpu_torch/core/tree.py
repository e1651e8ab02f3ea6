"""Parameter paths shared by the partitioning rules and LoRA.

Port of ``avsl_tpu/core/tree.py`` (``path_str``), plus the map from the
port's state-dict keys (OpenAI Whisper and fairseq names) to the JAX
package's flax paths, which the rule tables of
:mod:`avsl_tpu_torch.core.partitioning` and the LoRA targets of
:mod:`avsl_tpu_torch.models.lora` are written against, and the dimension
order that ``models/convert.py`` gives each weight: flax keeps a Linear
kernel ``[in, out]`` and torch ``[out, in]``, and convolution kernels
move their channel dims to the front.
"""

from __future__ import annotations

import re
from typing import Tuple

_TOWER = "video_model/av_hubert/encoder/"
_WHISPER_PROJ = {"query": "q_proj", "key": "k_proj", "value": "v_proj", "out": "out_proj"}


def _leaf(kind: str) -> str:
    return "kernel" if kind == "weight" else "bias"


# the prefix of an AV-HuBERT encoder's keys, and its flax path
_AV = r"^(video_model\.|encoder\.w2v_model\.|)"
_AV_PATHS = {"video_model.": _TOWER, "encoder.w2v_model.": "avhubert/encoder/",
             "": "avhubert/encoder/"}


def _av(m) -> str:
    return _AV_PATHS[m[1]]


# (regex over a state-dict key of a Whisper(-Flamingo) or AV-HuBERT model,
# the flax path as a function of the match); the last group of a Linear's
# pattern is "weight" or "bias"
_FLAX_PATHS = [
    (r"^decoder\.token_embedding\.weight$", lambda m: "decoder/token_embedding/embedding"),
    (r"^decoder\.positional_embedding$", lambda m: "decoder/positional_embedding"),
    (r"^video_projection\.(weight|bias)$", lambda m: f"video_projection/{_leaf(m[1])}"),
    (r"^(encoder|decoder)\.blocks\.(\d+)\.(attn|cross_attn|x_attn)\.(query|key|value|out)\."
     r"(weight|bias)$",
     lambda m: (f"{m[1]}/block_{m[2]}/{'self_attn' if m[3] == 'attn' else m[3]}/"
                f"{_WHISPER_PROJ[m[4]]}/{_leaf(m[5])}")),
    (r"^(encoder|decoder)\.blocks\.(\d+)\.(mlp|x_mlp)\.(0|2)\.(weight|bias)$",
     lambda m: f"{m[1]}/block_{m[2]}/{m[3]}/fc{1 if m[4] == '0' else 2}/{_leaf(m[5])}"),
    # an AV-HuBERT encoder: the Whisper-Flamingo tower ("video_model."),
    # the fine-tune heads' ("encoder.w2v_model.") or the pretraining
    # model's (at the top level)
    (_AV + r"post_extract_proj\.(weight|bias)$",
     lambda m: f"{_av(m)}post_extract_proj/{_leaf(m[2])}"),
    (_AV + r"feature_extractor_(video|audio)\.proj\.(weight|bias)$",
     lambda m: (f"{_av(m)}{m[2]}_encoder/proj/{_leaf(m[3])}"
                .replace("video_encoder", "visual_encoder"))),
    (_AV + r"encoder\.layers\.(\d+)\.(fc1|fc2)\.(weight|bias)$",
     lambda m: f"{_av(m)}transformer/layer_{m[2]}/mlp/{m[3]}/{_leaf(m[4])}"),
    (_AV + r"encoder\.layers\.(\d+)\.mlp\.(router|w_in|b_in|w_out|b_out)$",
     lambda m: f"{_av(m)}transformer/layer_{m[2]}/mlp/{m[3]}"),
    (_AV + r"encoder\.layers\.(\d+)\.self_attn\.(q_proj|k_proj|v_proj|out_proj)\."
     r"(weight|bias)$",
     lambda m: f"{_av(m)}transformer/layer_{m[2]}/self_attn/{m[3]}/{_leaf(m[4])}"),
    # the AV-HuBERT seq2seq decoder and the heads
    (r"^decoder\.layers\.(\d+)\.(self_attn|encoder_attn)\.(q_proj|k_proj|v_proj|out_proj)\."
     r"(weight|bias)$",
     lambda m: (f"decoder/layer_{m[1]}/{'self_attn' if m[2] == 'self_attn' else 'cross_attn'}/"
                f"{m[3]}/{_leaf(m[4])}")),
    (r"^decoder\.layers\.(\d+)\.(fc1|fc2)\.(weight|bias)$",
     lambda m: f"decoder/layer_{m[1]}/mlp/{m[2]}/{_leaf(m[3])}"),
    (r"^decoder\.embed_tokens\.weight$", lambda m: "decoder/embed_tokens/embedding"),
    (r"^decoder\.embed_positions\.weight$", lambda m: "decoder/embed_positions"),
    (r"^decoder\.output_projection\.weight$", lambda m: "decoder/output_proj/kernel"),
    (r"^(ctc_head|final_proj)\.(weight|bias)$", lambda m: f"{m[1]}/{_leaf(m[2])}"),
    (r"^label_embs_concat$", lambda m: "label_embs"),
]

# torch dim j of a kernel holds flax dim _KERNEL_ORDER[ndim][j]
# (``models/convert.py::_to_torch_layout``)
_KERNEL_ORDER = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_NOT_KERNELS = re.compile(r"(token_embedding|embed_tokens|positional_embedding|"
                          r"embed_positions|label_embs_concat)")


def path_str(path: Tuple) -> str:
    """Join a tree path into 'a/b/c': a part with ``.key`` gives its key,
    with ``.name`` its name, with ``.idx`` its index, else ``str()``."""
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "name"):
            parts.append(str(p.name))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


def flax_path(key: str) -> str:
    """The JAX package's flax path ("/"-joined, without the collection) of
    the port's parameter ``key`` of a Whisper(-Flamingo) model or an
    AV-HuBERT fine-tune or pretraining model, for its 2-D weights, the
    Linear biases and the MoE leaves: the inverse of
    ``models/convert.py``'s ``flax_path_to_torch_key``,
    ``avhubert_flax_path_to_torch_key`` and
    ``pretrain_flax_path_to_torch_key``. Raises KeyError
    for a key it does not know."""
    for pattern, build in _FLAX_PATHS:
        m = re.match(pattern, key)
        if m:
            return build(m)
    raise KeyError(f"{key}: no flax path known for this parameter")


def rule_path(key: str) -> str:
    """The path the partitioning rules read for ``key``: its flax path
    where :func:`flax_path` knows it (a LoRA adapter's is JAX's adapter
    path, which no rule names), else the key "/"-joined (norms,
    convolutions, BatchNorm and the other leaves, which no rule of the
    table names)."""
    lora = re.match(r"^(lora_a|lora_b)\.(.+)$", key)
    if lora:  # a LoRA adapter, keyed by its flax path: JAX's ".../kernel/lora_a"
        return f"{lora[2]}/{lora[1]}"
    try:
        return flax_path(key)
    except KeyError:
        return key.replace(".", "/")


def flax_dims(key: str, ndim: int) -> Tuple[int, ...]:
    """For each dim of the port's tensor ``key`` (``ndim`` dims), the dim
    of the JAX package's array it holds: a Linear weight and a
    convolution kernel are permuted (``[out, in]`` against flax's ``[in,
    out]``), every other leaf keeps its order."""
    name = key.rsplit(".", 1)[-1]
    if name in ("weight", "weight_v") and ndim in _KERNEL_ORDER and not _NOT_KERNELS.search(key):
        return _KERNEL_ORDER[ndim]
    return tuple(range(ndim))
