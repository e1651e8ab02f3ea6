"""Weight-only int8 serving and the int8 decode cache.

Port of ``avsl_tpu/models/quant.py``: :class:`QTensor` (int8 ``q`` and a
broadcastable fp32 ``scale``), :func:`quantize_array` and
:func:`quantize_rows` (symmetric absmax / 127 in fp32, round half to
even, clipped to +-127, bit for bit the JAX functions'),
:func:`quantize_kv_cache`, :func:`default_predicate`, :func:`tree_bytes`
and :func:`quantization_report`. The JAX ``quantize_tree`` /
``dequantize_tree`` pair over a param tree becomes
:func:`quantize_model` over a module: a copy of the model whose eligible
weights are held as int8 and dequantized at each use.

Which weights are quantized, and along which axis, follows the JAX
package's param paths, which the weight carrier (``models/convert.py``)
maps onto the port's names. JAX scales per ROW the leaves whose path ends
in ``embedding`` or ``label_embs`` (Whisper's ``token_embedding`` and
decoder ``positional_embedding``, AV-HuBERT's ``embed_tokens``) and per
output channel every other leaf: a flax kernel's last axis, which is the
first axis of the port's ``[out, in, ...]`` weights (the weight-normed
``pos_conv``'s ``weight_v`` included), and the last axis of a table the
carrier keeps in the flax layout (AV-HuBERT's learned ``embed_positions``,
a bare param in JAX). Gates, norms, biases, anything under 2-D or 4096
elements, and buffers (the BatchNorm statistics, the sinusoid tables,
which are no JAX params) stay float; ``weight_g``, a 1-D scale in flax
held as ``[out, 1, 1]`` here, stays float too.

The JAX serving program dequantizes to bf16 whatever the model's dtype
(``dequantize_tree``'s default) and the layers then cast as they always
do; so does the port: ``q * scale`` in fp32 rounded to bf16, then the
model's cast at use. The int8 tensors (and their scales) are what stays
resident: each quantized weight is a ``torch.nn.utils.parametrize``
parametrization whose two buffers are ``q`` and ``scale``, and the
bf16 tensor exists only while the op that reads it runs (one launch a
use: the product is written into a bf16 output, rounding once as JAX's
``astype`` does). The dequantize-then-``F.linear`` stays plain torch, as
the JAX package leaves it to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import copy
import itertools
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence

import torch
from torch import nn
from torch.nn.utils import parametrize


class QTensor(NamedTuple):
    """An int8-quantized tensor: ``dequant = q * scale``; ``q`` int8 with the
    original shape, ``scale`` fp32 broadcastable against it (keepdims)."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def dequantize(self, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """``(float32(q) * scale)`` rounded once to ``dtype``."""
        out = torch.empty(self.q.shape, dtype=dtype, device=self.q.device)
        return torch.mul(self.q, self.scale, out=out)


def _quantize(w: torch.Tensor, axes: Sequence[int]) -> QTensor:
    """Symmetric int8 with the absmax over ``axes`` (kept): scale =
    absmax / 127 where the absmax is nonzero, else 1. The divisor is a
    tensor on ``w``'s device, so the card divides as the CPU does (a CPU
    scalar divisor becomes a product with its reciprocal there)."""
    w = w.to(torch.float32)
    amax = w.abs().amax(dim=tuple(axes), keepdim=True)
    scale = torch.where(amax > 0, amax / torch.tensor(127.0, device=w.device),
                        torch.ones((), device=w.device))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale)


def quantize_array(w: torch.Tensor, channel_axis: int = -1) -> QTensor:
    """Symmetric per-channel int8: the scale is max|w| / 127 over every axis
    but ``channel_axis``."""
    keep = channel_axis % w.ndim
    return _quantize(w, [a for a in range(w.ndim) if a != keep])


def quantize_rows(x: torch.Tensor) -> QTensor:
    """Symmetric int8 with a scale per row: the absmax over the LAST axis
    only (scale shape ``x.shape[:-1] + (1,)``), the granularity of a K/V
    cache entry."""
    return _quantize(x, [x.ndim - 1])


def quantize_kv_cache(caches: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """int8-compress the static entries of a decode cache built by
    ``init_decode_cache`` (Whisper's or AV-HuBERT's): every ``{"k", "v"}``
    entry without an ``"index"`` (the cross-attention and Flamingo
    ``"xv"`` K/V, re-read on every decode step) becomes per-row
    :class:`QTensor` pairs over the head dimension of the port's
    head-major [B,H,T,D] layout (the same rows as JAX's [B,T,H,D]). The
    incremental ``"self"`` buffers stay in the model dtype. Attention
    dequantizes on read (``models/layers.py``)."""

    def one(entry):
        out = {}
        for name, sub in entry.items():
            if (isinstance(sub, dict) and "index" not in sub and "k" in sub and "v" in sub
                    and not isinstance(sub["k"], QTensor)):
                out[name] = {"k": quantize_rows(sub["k"]), "v": quantize_rows(sub["v"])}
            else:
                out[name] = sub
        return out

    return [one(e) for e in caches]


def default_predicate(name: str, tensor: torch.Tensor) -> bool:
    """Quantize float tensors with >= 2 dims and >= 4096 elements, except
    gates and batch statistics (the JAX predicate, on the port's names)."""
    if not tensor.is_floating_point() or tensor.ndim < 2 or tensor.numel() < 4096:
        return False
    lowered = name.lower()
    return "gate" not in lowered and "batch_stats" not in lowered and not name.endswith("weight_g")


# JAX scales a table whose flax path ends in "embedding" or "label_embs" per
# row and a flax kernel [in, ..., out] per output channel: both are axis 0 in
# the port's [V, D] / [out, in, ...] layout. Only the tables the carrier keeps
# in the flax layout differ, scaled over their last axis.
_FLAX_LAYOUT = ("embed_positions.weight",)


def channel_axis(name: str) -> int:
    """The axis that keeps its own scale for the port's weight ``name``."""
    return -1 if name.endswith(_FLAX_LAYOUT) else 0


class Dequantize(nn.Module):
    """Parametrization of a weight held as int8: ``right_inverse`` quantizes
    the float value along ``axis``, the forward dequantizes to bf16."""

    def __init__(self, axis: int):
        super().__init__()
        self.axis = axis

    def forward(self, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return QTensor(q, scale).dequantize(torch.bfloat16)

    def right_inverse(self, w: torch.Tensor):
        return tuple(quantize_array(w, self.axis))


def quantize_model(model: nn.Module,
                   weights: Optional[Mapping[str, torch.Tensor]] = None) -> nn.Module:
    """A copy of ``model`` whose eligible weights (:func:`default_predicate`) are int8
    with per-channel fp32 scales (:func:`channel_axis`), dequantized to
    bf16 at each use; every other parameter and buffer is shared with
    ``model``, which is left as it was. Each weight is quantized from its
    entry in ``weights`` (the fp32 state dict a checkpoint or the carrier
    gives) when there is one, else from the model's own values. Weights
    already quantized are buffers of their parametrization, so a second
    pass leaves them as they are."""
    shared = itertools.chain(model.parameters(), model.buffers())
    qmodel = copy.deepcopy(model, memo={id(t): t for t in shared})
    for name, param in list(qmodel.named_parameters()):
        owner_name, _, attr = name.rpartition(".")
        owner = qmodel.get_submodule(owner_name)
        if not default_predicate(name, param):
            continue
        source = param.detach() if weights is None or name not in weights else weights[name]
        source = source.to(device=param.device, dtype=torch.float32)
        if tuple(source.shape) != tuple(param.shape):
            raise ValueError(f"{name}: weights give {tuple(source.shape)}, the model holds "
                             f"{tuple(param.shape)}")
        # the copy's attribute becomes a plain tensor (the caller's
        # Parameter keeps its flags), which the parametrization replaces by
        # its two buffers
        del owner._parameters[attr]
        owner.register_buffer(attr, source)
        parametrize.register_parametrization(owner, attr, Dequantize(channel_axis(name)),
                                             unsafe=True)
    return qmodel


def quantized_weights(model: nn.Module) -> Dict[str, QTensor]:
    """The int8 weights of a :func:`quantize_model` copy, by the weight's
    name in the float model."""
    out = {}
    for mod_name, module in model.named_modules():
        for attr, plist in getattr(module, "parametrizations", {}).items():
            if isinstance(plist[0], Dequantize):
                name = f"{mod_name}.{attr}" if mod_name else attr
                out[name] = QTensor(plist.original0, plist.original1)
    return out


def tree_bytes(model: nn.Module) -> int:
    """Bytes the module holds: every parameter and buffer (a quantized
    weight counts its int8 ``q`` and fp32 ``scale``)."""
    return int(sum(t.numel() * t.element_size()
                   for t in itertools.chain(model.parameters(), model.buffers())))


def quantization_report(model: nn.Module, qmodel: nn.Module) -> dict:
    """JAX's report of a float model and its :func:`quantize_model` copy:
    ``bytes_fp32`` (what the float model's tensors take in fp32, as the
    JAX variables hold them), ``bytes_quantized``, ``compression`` and
    ``n_quantized_leaves``; plus ``bytes_float``, what the float model
    holds in its own dtypes (bf16 weights when serving)."""
    tensors = list(itertools.chain(model.parameters(), model.buffers()))
    before = int(sum(t.numel() * 4 if t.is_floating_point() else t.numel() * t.element_size()
                     for t in tensors))
    after = tree_bytes(qmodel)
    return {"bytes_fp32": before, "bytes_quantized": after,
            "compression": before / max(after, 1),
            "n_quantized_leaves": len(quantized_weights(qmodel)),
            "bytes_float": tree_bytes(model)}
