"""Weight carrier: flax Whisper(-Flamingo) and AV-HuBERT variables -> the
port's state dict.

The inverse of ``avsl_tpu/models/convert.py``'s ``convert_whisper_state_dict``
(its ``_WHISPER_RULES`` renames and ``_to_flax_array`` transposes) and, for
the AV-HuBERT video tower under ``video_model/av_hubert/encoder/`` and for
the ``AVHuBERTForSpeech2Text`` / ``AVHuBERTForCTC`` trees
(``avhubert/encoder/...``, ``decoder/...``, ``ctc_head``), of its
``convert_avhubert_state_dict`` (fairseq names; the heads' encoder under
``encoder.w2v_model.``, which that converter strips). The pretraining
model ``AVHuBERTForPretraining`` goes to fairseq ``AVHubertModel``'s names
(the encoder's modules at the top level, ``final_proj``,
``label_embs_concat``). An MoE encoder's FFN leaves
(``layer_i/mlp/{router,w_in,b_in,w_out,b_out}``) keep their names and
layouts under ``encoder.layers.i.mlp.``. The decoder's
sinusoid table is recomputed, not carried. Linear kernels go from
flax [in, out] to torch [out, in], Conv1d kernels from [k, in, out] to
[out, in, k], Conv2d kernels from [kh, kw, in, out] to [out, in, kh, kw]
and the Conv3d stem from [5, 7, 7, 1, C] to [C, 1, 5, 7, 7]; LayerNorm and
BatchNorm ``scale`` become ``weight``, the ``batch_stats`` ``mean``/``var``
become ``running_mean``/``running_var``, PReLU ``negative_slope`` becomes
``weight``; the encoder's sinusoid position table, a buffer in the OpenAI
model, is recomputed.

The weight-normed positional conv keeps flax ``nn.WeightNorm``'s
parametrisation (a scale per output channel over the unit-norm kernel),
so its kernel [k, in/groups, out] becomes ``weight_v`` [out, in/groups, k]
and its ``scale`` [out] becomes ``weight_g`` [out, 1, 1], and the port
computes the same effective kernel in fp32. (fairseq's checkpoints use
another parametrisation, ``weight_norm(dim=2)``, a scale per tap: the JAX
converter recombines those into the effective kernel first.)

``load_torch_checkpoint_into`` reads a PyTorch Whisper checkpoint (the
``pt_ckpt`` of the training config) into the model through
``partial_load``'s triage, as the JAX package's function of that name does.

The state dict is fp32, as the JAX state holds its params.
``load_state_dict`` copies each value into the module's own dtype: a
model built with ``param_dtype="float32"`` carries the fp32 values
exactly, and one whose weights are stored in bf16 (serving) rounds them,
as flax rounds fp32 params to bf16 at each use; norms, BatchNorm, PReLU
slopes, the weight-norm factors and the gates stay fp32 either way.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from avsl_tpu_torch.models.layers import sinusoid_embedding

_AV_PREFIX = "video_model/av_hubert/encoder/"

# (regex, replacement) applied in order to each "/"-joined flax path
# outside the video tower
_FLAX_TO_TORCH_RULES: List[Tuple[str, str]] = [
    (r"/LayerNorm_0/scale$", r"/weight"),
    (r"/LayerNorm_0/bias$", r"/bias"),
    (r"^decoder/token_embedding/embedding$", r"decoder/token_embedding/weight"),
    (r"/kernel$", r"/weight"),
    (r"/block_(\d+)/", r"/blocks/\1/"),
    (r"/self_attn_ln/", r"/attn_ln/"),
    (r"/(self_attn|cross_attn|x_attn)/q_proj/", r"/\1/query/"),
    (r"/(self_attn|cross_attn|x_attn)/k_proj/", r"/\1/key/"),
    (r"/(self_attn|cross_attn|x_attn)/v_proj/", r"/\1/value/"),
    (r"/(self_attn|cross_attn|x_attn)/out_proj/", r"/\1/out/"),
    (r"/self_attn/", r"/attn/"),
    (r"/(x_mlp|mlp)/fc1/", r"/\1/0/"),
    (r"/(x_mlp|mlp)/fc2/", r"/\1/2/"),
    (r"/", r"."),
]

# the same for paths inside an AV-HuBERT encoder (after _AV_PREFIX or
# "avhubert/encoder/"), to fairseq AV-HuBERT names ("/"-joined)
_AV_ENCODER_RULES: List[Tuple[str, str]] = [
    (r"^audio_encoder/conv_frontend/", r"feature_extractor_audio/conv_frontend/"),
    (r"^audio_encoder/proj/", r"feature_extractor_audio/proj/"),
    (r"^visual_encoder/frontend/stem_conv/kernel$",
     r"feature_extractor_video/resnet/frontend3D/0/weight"),
    (r"^visual_encoder/frontend/stem_bn/", r"feature_extractor_video/resnet/frontend3D/1/"),
    (r"^visual_encoder/frontend/stem_prelu/negative_slope$",
     r"feature_extractor_video/resnet/frontend3D/2/weight"),
    (r"^visual_encoder/frontend/trunk/layer(\d)_(\d+)/",
     r"feature_extractor_video/resnet/trunk/layer\1/\2/"),
    (r"^visual_encoder/proj/", r"feature_extractor_video/proj/"),
    (r"/prelu(\d)/negative_slope$", r"/relu\1/weight"),
    (r"/downsample_conv/", r"/downsample/0/"),
    (r"/downsample_bn/", r"/downsample/1/"),
    (r"/mean$", r"/running_mean"),
    (r"/var$", r"/running_var"),
    (r"/scale$", r"/weight"),
    (r"^fuse_ln/LayerNorm_0/", r"layer_norm/"),
    (r"^transformer/pos_conv/WeightNorm_0/conv/kernel/weight$", r"encoder/pos_conv/0/weight_g"),
    (r"^transformer/pos_conv/conv/kernel$", r"encoder/pos_conv/0/weight_v"),
    (r"^transformer/pos_conv/conv/bias$", r"encoder/pos_conv/0/bias"),
    (r"^transformer/ln_post/LayerNorm_0/", r"encoder/layer_norm/"),
    (r"^transformer/ln_pre/LayerNorm_0/", r"encoder/layer_norm/"),
    (r"^transformer/layer_(\d+)/self_attn_ln/LayerNorm_0/",
     r"encoder/layers/\1/self_attn_layer_norm/"),
    (r"^transformer/layer_(\d+)/mlp_ln/LayerNorm_0/", r"encoder/layers/\1/final_layer_norm/"),
    # the MoE FFN's leaves (not kernels: carried as they are)
    (r"^transformer/layer_(\d+)/mlp/(router|w_in|b_in|w_out|b_out)$",
     r"encoder/layers/\1/mlp/\2"),
    (r"^transformer/layer_(\d+)/mlp/", r"encoder/layers/\1/"),
    (r"^transformer/layer_(\d+)/", r"encoder/layers/\1/"),
    (r"/kernel$", r"/weight"),
]
_AV_FLAX_TO_TORCH_RULES = _AV_ENCODER_RULES + [(r"^", r"video_model/"), (r"/", r".")]

# the AV-HuBERT decoder (after "decoder/") to fairseq names
_AV_DECODER_RULES: List[Tuple[str, str]] = [
    (r"^embed_tokens/embedding$", r"embed_tokens/weight"),
    (r"^embed_positions$", r"embed_positions/weight"),
    (r"^layer_(\d+)/self_attn_ln/LayerNorm_0/", r"layers/\1/self_attn_layer_norm/"),
    (r"^layer_(\d+)/cross_attn_ln/LayerNorm_0/", r"layers/\1/encoder_attn_layer_norm/"),
    (r"^layer_(\d+)/mlp_ln/LayerNorm_0/", r"layers/\1/final_layer_norm/"),
    (r"^layer_(\d+)/cross_attn/", r"layers/\1/encoder_attn/"),
    (r"^layer_(\d+)/mlp/", r"layers/\1/"),
    (r"^layer_(\d+)/", r"layers/\1/"),
    (r"^ln/LayerNorm_0/scale$", r"layer_norm/weight"),
    (r"^ln/LayerNorm_0/", r"layer_norm/"),
    (r"^output_proj/", r"output_projection/"),
    (r"/scale$", r"/weight"),
    (r"/kernel$", r"/weight"),
]


def flax_path_to_torch_key(path: str) -> str:
    """A flax variable path ("/"-joined, without the collection) -> the
    port's state-dict key."""
    if path.startswith(_AV_PREFIX):
        path, rules = path[len(_AV_PREFIX):], _AV_FLAX_TO_TORCH_RULES
    else:
        rules = _FLAX_TO_TORCH_RULES
    for pat, rep in rules:
        path = re.sub(pat, rep, path)
    return path


def avhubert_flax_path_to_torch_key(path: str) -> str:
    """A flax path of ``AVHuBERTForSpeech2Text`` or ``AVHuBERTForCTC``
    (without the collection) -> the port's fairseq state-dict key."""
    for prefix, rules, out in (("avhubert/encoder/", _AV_ENCODER_RULES, "encoder/w2v_model/"),
                               ("decoder/", _AV_DECODER_RULES, "decoder/"),
                               ("ctc_head/", [(r"kernel$", r"weight")], "ctc_head/")):
        if path.startswith(prefix):
            path = path[len(prefix):]
            for pat, rep in rules:
                path = re.sub(pat, rep, path)
            return (out + path).replace("/", ".")
    raise KeyError(f"{path}: not a path of the AV-HuBERT seq2seq or CTC model")


def pretrain_flax_path_to_torch_key(path: str) -> str:
    """A flax path of ``AVHuBERTForPretraining`` (without the collection)
    -> the port's key, fairseq ``AVHubertModel``'s: the encoder's modules
    at the top level, ``final_proj`` and ``label_embs_concat``."""
    if path.startswith("avhubert/encoder/"):
        path = path[len("avhubert/encoder/"):]
        for pat, rep in _AV_ENCODER_RULES:
            path = re.sub(pat, rep, path)
        return path.replace("/", ".")
    if path == "label_embs":
        return "label_embs_concat"
    if path.startswith("final_proj/"):
        return re.sub(r"kernel$", "weight", path).replace("/", ".")
    raise KeyError(f"{path}: not a path of the AV-HuBERT pretraining model")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, path + "/"))
        else:
            out[path] = np.asarray(value)
    return out


def _to_torch_layout(path: str, value: np.ndarray) -> np.ndarray:
    if path.endswith("pos_conv/WeightNorm_0/conv/kernel/scale"):  # [out] -> [out, 1, 1]
        return value.reshape(-1, 1, 1)
    if path.endswith("/kernel"):
        if value.ndim == 2:  # Linear: flax [in, out] -> torch [out, in]
            return value.T
        if value.ndim == 3:  # Conv1d: flax [k, in, out] -> torch [out, in, k]
            return value.transpose(2, 1, 0)
        if value.ndim == 4:  # Conv2d: [kh, kw, in, out] -> [out, in, kh, kw]
            return value.transpose(3, 2, 0, 1)
        if value.ndim == 5:  # Conv3d: [kt, kh, kw, in, out] -> [out, in, kt, kh, kw]
            return value.transpose(4, 3, 0, 1, 2)
    return value


def _strip_collection(flat: Dict[str, np.ndarray], collection: str) -> Dict[str, np.ndarray]:
    return {re.sub(f"^{collection}/", "", k): v for k, v in flat.items()}


def state_dict_from_flax(
    params: Mapping[str, Any], batch_stats: Optional[Mapping[str, Any]] = None,
    key_fn=flax_path_to_torch_key,
) -> Dict[str, torch.Tensor]:
    """Flax variables (nested mappings or flat "/" paths, with or without
    the ``params``/``batch_stats`` level) -> fp32 torch tensors under the
    port's state-dict keys (``key_fn`` of each path), one per variable."""
    flat = _strip_collection(_flatten(params), "params")
    if batch_stats is not None:
        flat.update(_strip_collection(_flatten(batch_stats), "batch_stats"))
    sd: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        arr = np.ascontiguousarray(_to_torch_layout(path, value), dtype=np.float32)
        sd[key_fn(path)] = torch.from_numpy(arr)
    return sd


def avhubert_state_dict_from_flax(
    params: Mapping[str, Any], batch_stats: Optional[Mapping[str, Any]] = None
) -> Dict[str, torch.Tensor]:
    """Flax ``AVHuBERTForSpeech2Text`` or ``AVHuBERTForCTC`` variables ->
    the port's fp32 state dict (fairseq names)."""
    return state_dict_from_flax(params, batch_stats, key_fn=avhubert_flax_path_to_torch_key)


def pretrain_state_dict_from_flax(
    params: Mapping[str, Any], batch_stats: Optional[Mapping[str, Any]] = None
) -> Dict[str, torch.Tensor]:
    """Flax ``AVHuBERTForPretraining`` variables -> the port's fp32 state
    dict under fairseq ``AVHubertModel``'s names, the keys the JAX
    converter drops (``avsl_tpu/models/convert.py:286-289``) included, so a
    fairseq-pretrained state dict loads into the port as it is."""
    return state_dict_from_flax(params, batch_stats, key_fn=pretrain_flax_path_to_torch_key)


def whisper_state_dict_from_flax(
    params: Mapping[str, Any],
    n_audio_ctx: int = 1500,
    batch_stats: Optional[Mapping[str, Any]] = None,
) -> Dict[str, torch.Tensor]:
    """Flax Whisper(-Flamingo) params and, for a model with the AV-HuBERT
    video tower, its ``batch_stats`` -> the port's fp32 torch state dict,
    including the ``encoder.positional_embedding`` sinusoid buffer of
    ``n_audio_ctx`` rows."""
    sd = state_dict_from_flax(params, batch_stats)
    width = sd["encoder.conv1.weight"].shape[0]
    sd["encoder.positional_embedding"] = torch.from_numpy(
        sinusoid_embedding(n_audio_ctx, width)
    )
    return sd


# embedding and output tensors: losing one of them to a shape mismatch or a
# renamed key would train from random weights while claiming to be loaded
_CRITICAL = re.compile(
    r"(token_embedding|embed_tokens|positional_embedding|embed_positions|output_proj|lm_head)")


def load_torch_checkpoint_into(model: torch.nn.Module, path: str,
                               allow_embedding_mismatch: bool = False) -> Dict[str, List[str]]:
    """Read a PyTorch state dict (nested under ``model_state_dict``,
    ``state_dict`` or ``model`` or not, keys optionally prefixed
    ``model.``) into ``model`` in place through ``partial_load``; returns
    its report. Read with ``weights_only=True``. Raises when an
    embedding or output tensor is skipped (shape mismatch or unexpected
    key), or missing while a sibling of its top-level module loaded,
    unless ``allow_embedding_mismatch``."""
    from avsl_tpu_torch.train.checkpoints import partial_load

    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model_state_dict", "state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    if not isinstance(obj, dict):
        raise ValueError(f"Unrecognized checkpoint structure in {path}")
    state = {re.sub(r"^model\.", "", k): v for k, v in obj.items() if torch.is_tensor(v)}
    _, report = partial_load(model, state)
    loaded_tops = {k.split(".")[0] for k in state}
    critical = [k for bucket in ("shape_mismatch", "unexpected") for k in report[bucket]
                if _CRITICAL.search(k)]
    critical += [k for k in report["missing"]
                 if _CRITICAL.search(k) and k.split(".")[0] in loaded_tops]
    if critical and not allow_embedding_mismatch:
        raise ValueError(f"checkpoint {path}: embedding/output tensors skipped (shape mismatch "
                         f"or key drift): {critical}")
    return report
