"""Transformer building blocks in PyTorch, with OpenAI Whisper names.

Port of the dense, pre-norm parts of ``avsl_tpu/models/layers.py``:
``LayerNormF32``, ``sinusoid_embedding``, ``dot_product_attention``,
``MultiHeadAttention`` (full sequence through the flash-attention kernels,
scalar-index self cache, precomputed cross cache), ``MLP`` (exact GELU)
and ``TransformerBlock`` with residual dropout. Module and parameter names
follow the OpenAI Whisper state dict (``attn.query``, ``attn_ln``,
``mlp.0``, ...).

Numerics follow the JAX package: projections run in the compute dtype;
attention logits, softmax and the weighted sum accumulate in fp32; layer
norm runs in fp32. Weights are stored in ``param_dtype`` (the compute
dtype when None). When the two differ, as in training (fp32 weights and
Adam state, bf16 compute), each weight is cast to the compute dtype at
use, so autograd returns fp32 gradients; when they agree (serving),
nothing is cast. The decode caches differ from the JAX package's in
two ways that change no value: they are written in place (the returned
cache holds the same tensors with the index advanced), and they are held
head-major, [B,H,T,D] in the model dtype, the layout the batched
products read, so a decode step copies none of them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avsl_tpu_torch.kernels.attention import fused_attention

Cache = Dict[str, Any]


def sinusoid_embedding(
    length: int, channels: int, max_timescale: float = 10000.0
) -> np.ndarray:
    """Whisper-style sinusoidal positions: ``[length, channels]``,
    ``[sin | cos]`` split halves with log-spaced timescales."""
    if channels % 2:
        raise ValueError(f"sinusoid_embedding needs an even channel count, got {channels}")
    log_timescale_increment = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(
        np.float32
    )


class LayerNormF32(nn.LayerNorm):
    """LayerNorm computed in fp32 (fp32 parameters) whatever the
    activation dtype; the output comes back in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__(dim, eps=eps, device=device, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        ).to(x.dtype)


def cast_param(p: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    """``p`` in ``dtype``: the tensor itself when it already is (serving),
    else a cast that autograd differentiates back to ``p``'s dtype."""
    return p if p is None or p.dtype == dtype else p.to(dtype)


class CastLinear(nn.Linear):
    """``nn.Linear`` whose weight and bias are cast to ``compute_dtype`` at
    use when they are stored in another dtype (flax ``Dense`` with
    ``dtype`` and ``param_dtype``)."""

    def __init__(self, in_features, out_features, bias=True, device=None,
                 param_dtype=torch.bfloat16, compute_dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=param_dtype)
        self.compute_dtype = compute_dtype or param_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, cast_param(self.weight, self.compute_dtype),
                        cast_param(self.bias, self.compute_dtype))


class CastConv1d(nn.Conv1d):
    """``nn.Conv1d`` whose weight and bias are cast to ``compute_dtype`` at
    use when they are stored in another dtype."""

    def __init__(self, *args, param_dtype=torch.bfloat16, compute_dtype=None, **kw):
        super().__init__(*args, dtype=param_dtype, **kw)
        self.compute_dtype = compute_dtype or param_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, cast_param(self.weight, self.compute_dtype),
                                  cast_param(self.bias, self.compute_dtype))


def residual_dropout(
    x: torch.Tensor, rate: float, training: bool, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability ``1 - rate``
    and scale it by ``1 / (1 - rate)``; the identity outside training. The
    mask is drawn from ``generator`` (``F.dropout`` takes none)."""
    if not training or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs an explicit torch.Generator")
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over [..., M, K] x [..., K, N] with fp32 products and an
    fp32 result, as the JAX einsum with ``preferred_element_type=float32``.
    Half-precision CUDA operands go to the GEMM as they are, with an fp32
    output; other operands are upcast first (bf16 to fp32 is exact)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        out = torch.bmm(a.flatten(0, -3), b.flatten(0, -3), out_dtype=torch.float32)
        return out.view(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a.float(), b.float())


def head_major_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[B,H,Q,D] x [B,H,K,D] -> [B,H,Q,D]; the body of
    :func:`dot_product_attention` over head-major operands."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = _matmul_f32(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return _matmul_f32(weights, v).to(q.dtype)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[B,Q,H,D] x [B,K,H,D] -> [B,Q,H,D]; fp32 logits and softmax; mask
    True = attend, masked logits take ``finfo(float32).min``. Weights are
    cast to ``q.dtype`` before the fp32-accumulated weighted sum."""
    out = head_major_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask)
    return out.transpose(1, 2)


def init_self_attn_cache(
    batch: int, max_len: int, n_heads: int, head_dim: int, dtype, device
) -> Cache:
    """Self-attention KV cache for incremental decoding, head-major
    [B,H,max_len,D]; ``index`` is the number of positions already written
    (a host integer)."""
    shape = (batch, n_heads, max_len, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": 0,
    }


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention with an optional KV cache.

    * full sequence: ``mha(x)`` or ``mha(x, kv_src=enc)`` runs the
      flash-attention kernel (causal when ``causal``);
    * incremental self-attention: ``mha(x, cache=c)`` with
      ``c = {"k", "v", "index"}`` writes x's K/V at ``index`` and attends
      causally over the cached prefix;
    * cross-attention with ``cache={"k", "v"}`` from :meth:`precompute_kv`.
    Returns ``(out, new_cache)``; ``new_cache`` is None without a cache.
    """

    def __init__(self, d_model: int, n_heads: int, dtype=torch.bfloat16, device=None,
                 param_dtype=None):
        super().__init__()
        self.d_model, self.n_heads = d_model, n_heads
        kw = dict(device=device, param_dtype=param_dtype or dtype, compute_dtype=dtype)
        self.query = CastLinear(d_model, d_model, **kw)
        self.key = CastLinear(d_model, d_model, bias=False, **kw)  # whisper: no key bias
        self.value = CastLinear(d_model, d_model, **kw)
        self.out = CastLinear(d_model, d_model, **kw)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.view(b, t, self.n_heads, self.d_model // self.n_heads)

    def precompute_kv(self, kv_src: torch.Tensor) -> Cache:
        """Cross-attention K/V for the decode loop: the model-dtype
        projections, laid out head-major [B,H,T,D] once here."""
        return {
            "k": self._split(self.key(kv_src)).transpose(1, 2).contiguous(),
            "v": self._split(self.value(kv_src)).transpose(1, 2).contiguous(),
        }

    def forward(
        self,
        x: torch.Tensor,
        kv_src: Optional[torch.Tensor] = None,
        cache: Optional[Cache] = None,
        causal: bool = False,
    ) -> Tuple[torch.Tensor, Optional[Cache]]:
        q = self._split(self.query(x))
        new_cache = None
        if cache is not None and "index" in cache:
            idx = int(cache["index"])
            qlen, max_len = x.shape[1], cache["k"].shape[2]
            # dynamic_update_slice semantics: the start clamps so the
            # update fits inside the buffer
            start = max(0, min(idx, max_len - qlen))
            for name, proj in (("k", self.key), ("v", self.value)):
                cache[name][:, :, start:start + qlen] = self._split(proj(x)).transpose(1, 2)
            pos_ids = torch.arange(max_len, device=x.device)[None, :]
            q_ids = torch.arange(qlen, device=x.device)[:, None]
            attn_mask = (pos_ids <= q_ids + idx)[None, None]
            new_cache = {"k": cache["k"], "v": cache["v"], "index": idx + qlen}
            out = head_major_attention(q.transpose(1, 2), cache["k"], cache["v"], attn_mask)
            out = out.transpose(1, 2)
        elif cache is not None:
            out = head_major_attention(q.transpose(1, 2), cache["k"], cache["v"]).transpose(1, 2)
            new_cache = cache
        else:
            src = x if kv_src is None else kv_src
            k = self._split(self.key(src))
            v = self._split(self.value(src))
            out = fused_attention(q, k, v, causal=causal)
        b, t = out.shape[:2]
        return self.out(out.reshape(b, t, self.d_model)), new_cache


class MLP(nn.Sequential):
    """fc1 -> exact GELU -> fc2, named ``mlp.0`` / ``mlp.2`` as in Whisper."""

    def __init__(self, d_model: int, d_ff: int, dtype=torch.bfloat16, device=None,
                 param_dtype=None):
        kw = dict(device=device, param_dtype=param_dtype or dtype, compute_dtype=dtype)
        super().__init__(
            CastLinear(d_model, d_ff, **kw), nn.GELU(), CastLinear(d_ff, d_model, **kw)
        )


class TransformerBlock(nn.Module):
    """Dense pre-norm block: self-attention [+ cross-attention] + MLP, with
    dropout at ``dropout`` on each sublayer's output before the residual
    add (in training only)."""

    def __init__(
        self,
        d_model: int,
        n_heads: int,
        d_ff: int,
        has_cross_attn: bool = False,
        causal_self_attn: bool = False,
        dtype=torch.bfloat16,
        device=None,
        param_dtype=None,
        dropout: float = 0.0,
    ):
        super().__init__()
        self.causal_self_attn = causal_self_attn
        self.dropout = dropout
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.attn = MultiHeadAttention(d_model, n_heads, **kw)
        self.attn_ln = LayerNormF32(d_model, device=device)
        self.has_cross_attn = has_cross_attn
        if has_cross_attn:
            self.cross_attn = MultiHeadAttention(d_model, n_heads, **kw)
            self.cross_attn_ln = LayerNormF32(d_model, device=device)
        self.mlp = MLP(d_model, d_ff, **kw)
        self.mlp_ln = LayerNormF32(d_model, device=device)

    def _residual(self, x, delta, generator):
        return x + residual_dropout(delta, self.dropout, self.training, generator)

    def forward(
        self,
        x: torch.Tensor,
        enc: Optional[torch.Tensor] = None,
        cache: Optional[Cache] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Optional[Cache]]:
        new_cache: Optional[Cache] = {} if cache is not None else None
        h, c = self.attn(
            self.attn_ln(x),
            cache=None if cache is None else cache.get("self"),
            causal=self.causal_self_attn and cache is None,
        )
        x = self._residual(x, h, generator)
        if new_cache is not None:
            new_cache["self"] = c
        if self.has_cross_attn and (enc is not None or (cache or {}).get("cross")):
            h, c = self.cross_attn(
                self.cross_attn_ln(x), kv_src=enc,
                cache=None if cache is None else cache.get("cross"),
            )
            x = self._residual(x, h, generator)
            if new_cache is not None:
                new_cache["cross"] = c
        x = self._residual(x, self.mlp(self.mlp_ln(x)), generator)
        return x, new_cache
