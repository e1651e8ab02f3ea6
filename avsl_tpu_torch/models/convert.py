"""Weight carrier: flax Whisper params -> OpenAI-named torch state dict.

The inverse of ``avsl_tpu/models/convert.py::convert_whisper_state_dict``
(its ``_WHISPER_RULES`` renames and ``_to_flax_array`` transposes): Linear
kernels go from flax [in, out] to torch [out, in], Conv1d kernels from
[k, in, out] to [out, in, k], LayerNorm ``scale`` becomes ``weight``, and
the encoder's sinusoid position table, a buffer in the OpenAI model, is
recomputed.

The state dict is fp32, as the JAX train state holds its params.
``load_state_dict`` copies each value into the module's own dtype: a
model built with ``param_dtype="float32"`` (training) carries the fp32
values exactly, and one whose weights are stored in bf16 (serving)
rounds them, as flax rounds fp32 params to bf16 at each use.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from avsl_tpu_torch.models.layers import sinusoid_embedding

# (regex, replacement) applied in order to each "/"-joined flax path
_FLAX_TO_TORCH_RULES: List[Tuple[str, str]] = [
    (r"^params/", ""),
    (r"/LayerNorm_0/scale$", r"/weight"),
    (r"/LayerNorm_0/bias$", r"/bias"),
    (r"^decoder/token_embedding/embedding$", r"decoder/token_embedding/weight"),
    (r"/kernel$", r"/weight"),
    (r"/block_(\d+)/", r"/blocks/\1/"),
    (r"/self_attn_ln/", r"/attn_ln/"),
    (r"/(self_attn|cross_attn)/q_proj/", r"/\1/query/"),
    (r"/(self_attn|cross_attn)/k_proj/", r"/\1/key/"),
    (r"/(self_attn|cross_attn)/v_proj/", r"/\1/value/"),
    (r"/(self_attn|cross_attn)/out_proj/", r"/\1/out/"),
    (r"/self_attn/", r"/attn/"),
    (r"/mlp/fc1/", r"/mlp/0/"),
    (r"/mlp/fc2/", r"/mlp/2/"),
    (r"/", r"."),
]


def flax_path_to_torch_key(path: str) -> str:
    for pat, rep in _FLAX_TO_TORCH_RULES:
        path = re.sub(pat, rep, path)
    return path


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
    if path.endswith("/kernel"):
        if value.ndim == 2:  # Linear: flax [in, out] -> torch [out, in]
            return value.T
        if value.ndim == 3:  # Conv1d: flax [k, in, out] -> torch [out, in, k]
            return value.transpose(2, 1, 0)
    return value


def whisper_state_dict_from_flax(
    params: Mapping[str, Any], n_audio_ctx: int = 1500
) -> Dict[str, torch.Tensor]:
    """Flax Whisper params (nested mapping or flat "/" paths, with or
    without the ``params`` level) -> OpenAI-named fp32 torch state dict,
    including the ``encoder.positional_embedding`` sinusoid buffer of
    ``n_audio_ctx`` rows."""
    flat = _flatten(params)
    sd: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        arr = np.ascontiguousarray(_to_torch_layout(path, value), dtype=np.float32)
        sd[flax_path_to_torch_key(path)] = torch.from_numpy(arr)
    width = sd["encoder.conv1.weight"].shape[0]
    sd["encoder.positional_embedding"] = torch.from_numpy(
        sinusoid_embedding(n_audio_ctx, width)
    )
    return sd
