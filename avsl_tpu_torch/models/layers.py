"""Transformer building blocks in PyTorch, with OpenAI Whisper names.

Port of ``avsl_tpu/models/layers.py``:
``LayerNormF32``, ``sinusoid_embedding``, ``fairseq_sinusoid_embedding``,
``dot_product_attention``, ``MultiHeadAttention`` (full sequence through
the flash-attention kernels, with key lengths; an explicit ``mask`` sends
it down the unfused masked path; the self cache with a scalar index (a
host integer or a 0-dim device tensor) or a per-sequence [B] index
tensor, the precomputed cross cache, int8 or not),
``MLP`` (exact GELU, activation dropout) and ``TransformerBlock`` (pre- or
post-norm, the tanh-gated ``x_attn``/``x_mlp`` sublayers of
Whisper-Flamingo, residual, attention-weight and activation dropout, or
the MoE FFN of :mod:`.moe` in the MLP's place),
``grad_multiply`` and :func:`remat_block` (activation checkpointing of
one block with the policies ``block`` and ``dots``). Module and
parameter names follow the OpenAI Whisper state dict (``attn.query``,
``attn_ln``, ``mlp.0``, ...) or, for the AV-HuBERT encoder, fairseq's
(``self_attn.q_proj``, ``self_attn_layer_norm``, ``fc1``,
``encoder_attn``, ...).

Numerics follow the JAX package: projections run in the compute dtype;
attention logits, softmax and the weighted sum accumulate in fp32; layer
norm runs in fp32. Weights are stored in ``param_dtype`` (the compute
dtype when None). When the two differ, as in training (fp32 weights and
Adam state, bf16 compute), each weight is cast to the compute dtype at
use, so autograd returns fp32 gradients; when they agree (serving),
nothing is cast. An input in another dtype than the compute dtype (the
AV-HuBERT decoder's fp32 residual stream) is cast to it at each
projection, as a flax ``Dense`` promotes its input. The decode caches
differ from the JAX package's in
two ways that change no value: they are written in place (the returned
cache holds the same tensors with the index advanced), and they are held
head-major, [B,H,T,D] in the model dtype, the layout the batched
products read, so a decode step copies none of them.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avsl_tpu_torch.core.mesh import (
    copy_to_group,
    current_sequence_split,
    draw_rows,
    gather_from_group,
    reduce_from_group,
    sequence_split_scope,
)
from avsl_tpu_torch.kernels.attention import fused_attention
from avsl_tpu_torch.models.quant import QTensor

Cache = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name."""
    if name not in _DTYPES:
        raise ValueError(f"dtype {name!r} not supported; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


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


def fairseq_sinusoid_embedding(length: int, channels: int, padding_idx: int = 1) -> np.ndarray:
    """fairseq-layout sinusoidal positions (the AV-HuBERT decoder's):
    ``[length, channels]`` ``[sin | cos]`` halves, position ids offset by
    ``padding_idx + 1``; an odd channel count zero-pads the last column."""
    half = channels // 2
    emb_scale = np.log(10000.0) / (half - 1)
    inv = np.exp(np.arange(half) * -emb_scale)
    pos = np.arange(padding_idx + 1, length + padding_idx + 1)[:, None] * inv[None, :]
    out = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    if channels % 2 == 1:
        out = np.concatenate([out, np.zeros((length, 1))], axis=1)
    return out.astype(np.float32)


class LayerNormF32(nn.LayerNorm):
    """LayerNorm computed in fp32 (fp32 parameters) whatever the
    activation dtype; the output comes back in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__(dim, eps=eps, device=device, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, _seq_param(self.weight), _seq_param(self.bias),
            self.eps
        ).to(x.dtype)


def _seq_param(p: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A whole parameter that a block applies to its slice of the rows
    under sequence parallelism: its gradient is summed over the model
    group, where each rank holds the part from its rows."""
    split = current_sequence_split()
    return p if split is None or p is None else copy_to_group(p, split.group)


def cast_param(p: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    """``p`` in ``dtype``: the tensor itself when it already is (serving),
    else a cast that autograd differentiates back to ``p``'s dtype."""
    return p if p is None or p.dtype == dtype else p.to(dtype)


class CastLinear(nn.Linear):
    """``nn.Linear`` whose weight and bias are cast to ``compute_dtype`` at
    use when they are stored in another dtype (flax ``Dense`` with
    ``dtype`` and ``param_dtype``), as is an input in another dtype.

    Under tensor parallelism (:meth:`set_tensor_parallel`) the layer holds
    this model rank's rows of the weight and bias ("col": its slice of the
    output features; the input's gradient is summed over the group;
    "col_gather": the same, its output then all-gathered over the
    features, for a head whose loss every rank computes whole) or its
    columns of the weight ("row": the partial products are summed over
    the group, then the whole bias is added). Inside a block under
    sequence parallelism (``core/mesh.py::sequence_split_scope``) the
    column-parallel layer takes an input its sublayer has all-gathered
    over T (:func:`seq_enter`), and the row-parallel one reduce-scatters
    its partial products over T where it would all-reduce them."""

    def __init__(self, in_features, out_features, bias=True, device=None,
                 param_dtype=torch.bfloat16, compute_dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=param_dtype)
        self.compute_dtype = compute_dtype or param_dtype
        self.tp: Optional[Tuple[str, Any, int, int]] = None

    def set_tensor_parallel(self, mode: str, group, rank: int, size: int) -> None:
        """Run as the ``mode`` ("col", "col_gather" or "row") part ``rank``
        of ``size`` over ``group``; ``core/partitioning.py::shard_state``
        cuts the tensors."""
        if mode not in ("col", "col_gather", "row"):
            raise ValueError(f"tensor-parallel mode {mode!r}: 'col', 'col_gather' or 'row'")
        self.tp = (mode, group, rank, size)

    def output_split(self, dim: int) -> Optional[Tuple[int, int, int]]:
        """``(dim, rank, size)`` when the output's features along ``dim``
        are this rank's slice (column-parallel), else None: the ``split``
        of :func:`~avsl_tpu_torch.core.mesh.draw_rows`."""
        if self.tp is None or self.tp[0] != "col":
            return None
        return (dim, self.tp[2], self.tp[3])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        x = cast_param(x, dtype)
        if self.tp is None:
            return F.linear(x, cast_param(self.weight, dtype), cast_param(self.bias, dtype))
        mode, group = self.tp[:2]
        split = current_sequence_split()
        if mode != "row":
            x = x if split is not None else copy_to_group(x, group)
            y = F.linear(x, cast_param(self.weight, dtype), cast_param(self.bias, dtype))
            return y if mode == "col" else gather_from_group(y, group, -1)
        y = F.linear(x, cast_param(self.weight, dtype))
        y = reduce_from_group(y, group) if split is None else split.reduce_scatter(y)
        return y if self.bias is None else y + cast_param(_seq_param(self.bias), dtype)


def seq_enter(x: torch.Tensor, first: "CastLinear") -> torch.Tensor:
    """A sublayer's input under sequence parallelism, whole over T: for a
    column-parallel ``first`` layer all-gathered with a reduce-scattering
    backward, for a replicated one all-gathered (each rank then runs the
    sublayer whole); ``x`` itself outside it."""
    split = current_sequence_split()
    if split is None:
        return x
    return split.gather_for_product(x) if first.tp is not None else split.gather(x)


def seq_leave(y: torch.Tensor, last: "CastLinear") -> torch.Tensor:
    """A sublayer's output back in the split form: a row-parallel ``last``
    layer has reduce-scattered it already, a replicated one's whole output
    keeps this rank's slice; ``y`` itself outside sequence parallelism."""
    split = current_sequence_split()
    return y if split is None or last.tp is not None else split.scatter(y)


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
    x: torch.Tensor, rate: float, training: bool, generator: Optional[torch.Generator],
    split: Optional[Tuple[int, int, int]] = None,
) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability ``1 - rate``
    and scale it by ``1 / (1 - rate)``; the identity outside training. The
    mask is drawn from ``generator`` (``F.dropout`` takes none), over
    ``x``'s rows through :func:`~avsl_tpu_torch.core.mesh.draw_rows`
    (``split``: a dim of ``x`` that is this model rank's slice)."""
    if not training or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs an explicit torch.Generator")
    keep_prob = 1.0 - rate
    keep = draw_rows(lambda s: torch.rand(s, generator=generator, device=x.device),
                     x.shape, split) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class _GradMultiply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def grad_multiply(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Identity forward, gradient scaled by ``scale`` (AV-HuBERT's
    ``feature_grad_mult`` on the frontend features)."""
    return _GradMultiply.apply(x, scale)


REMAT_POLICIES = ("block", "dots")
# the number of remat recomputes running (BatchNorm leaves its running
# statistics alone in one)
_RECOMPUTING = [0]


def check_remat_policy(policy: str) -> str:
    """``policy`` when it is one of :data:`REMAT_POLICIES`, else the JAX
    ``remat_block``'s ValueError."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; known: {sorted(REMAT_POLICIES)}")
    return policy


def recomputing() -> bool:
    """Whether a :func:`remat_block` recompute is running."""
    return _RECOMPUTING[0] > 0


def _dots_saveable(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the outputs of the
    unbatched projection GEMMs, recompute everything else (attention
    internals, the flash-attention kernel, elementwise ops)."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_block(module: nn.Module, policy: str, generators: Sequence[Optional[torch.Generator]],
               *args, **kwargs):
    """``module(*args, **kwargs)`` under activation checkpointing, the JAX
    ``remat_block`` (``nn.remat``): ``torch.utils.checkpoint`` without
    reentrancy, saving nothing inside the block (``"block"``) or the
    outputs of its projection GEMMs (``"dots"``), and recomputing the rest
    in the backward. Without a gradient it is a plain call.

    The recompute draws what the forward drew: each of ``generators``
    (the explicit ones the block's dropouts draw from; ``checkpoint``
    saves only the global RNGs) is set back to its state before the
    forward, and after the recompute to the state it had when the
    recompute began. Tensors that shadowed the block's parameters during
    the forward (the LoRA merge, ``models/lora.py``) shadow them again
    during the recompute, and BatchNorm does not update its running
    statistics a second time (:func:`recomputing`)."""
    check_remat_policy(policy)
    if not torch.is_grad_enabled():
        return module(*args, **kwargs)
    from torch.utils.checkpoint import (
        checkpoint,
        create_selective_checkpoint_contexts,
        noop_context_fn,
    )

    gens = [g for g in generators if g is not None]
    before = [g.get_state() for g in gens]
    shadows = [(m, n, m.__dict__[n]) for m in module.modules() for n in m._parameters
               if n in m.__dict__]
    calls = [0]

    def run(*a, **kw):
        calls[0] += 1
        if calls[0] == 1:
            return module(*a, **kw)
        now = [g.get_state() for g in gens]
        for g, state in zip(gens, before):
            g.set_state(state)
        installed = [(m, n) for m, n, _ in shadows if n not in m.__dict__]
        for m, n, t in shadows:
            m.__dict__[n] = t
        _RECOMPUTING[0] += 1
        try:
            return module(*a, **kw)
        finally:
            _RECOMPUTING[0] -= 1
            for m, n in installed:
                del m.__dict__[n]
            for g, state in zip(gens, now):
                g.set_state(state)

    context_fn = (functools.partial(create_selective_checkpoint_contexts, _dots_saveable)
                  if policy == "dots" else noop_context_fn)
    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=context_fn, **kwargs)


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over [..., M, K] x [..., K, N] with fp32 products and an
    fp32 result, as the JAX einsum with ``preferred_element_type=float32``.
    Half-precision CUDA operands go to the GEMM as they are, with an fp32
    output, when no gradient is wanted (that GEMM has no derivative);
    other operands are upcast first (bf16 to fp32 is exact), which
    computes the same products."""
    wants_grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16) and not wants_grad:
        out = torch.bmm(a.flatten(0, -3), b.flatten(0, -3), out_dtype=torch.float32)
        return out.view(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a.float(), b.float())


def head_major_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    return_weights: bool = False,
    split: Optional[Tuple[int, int, int]] = None,
):
    """[B,H,Q,D] x [B,H,K,D] -> [B,H,Q,D]; the body of
    :func:`dot_product_attention` over head-major operands (with
    ``return_weights`` also the fp32 [B,H,Q,K] softmax weights; ``split``
    as :func:`residual_dropout`'s, for the weights' dropout)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = _matmul_f32(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    weights = residual_dropout(probs.to(q.dtype), dropout_rate, True, generator, split)
    out = _matmul_f32(weights, v).to(q.dtype)
    return (out, probs) if return_weights else out


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    return_weights: bool = False,
    split: Optional[Tuple[int, int, int]] = None,
):
    """[B,Q,H,D] x [B,K,H,D] -> [B,Q,H,D]; fp32 logits and softmax; mask
    True = attend, masked logits take ``finfo(float32).min``. Weights are
    cast to ``q.dtype``, then, with ``dropout_rate``, dropped with an
    inverted-scaled keep mask drawn from ``generator`` (fairseq's
    attention dropout), before the fp32-accumulated weighted sum. With
    ``return_weights`` also returns the fp32 [B,H,Q,K] softmax weights (the
    alignment capture, ``decode/word_timestamps.py``)."""
    out = head_major_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask,
                               dropout_rate, generator, return_weights, split)
    if return_weights:
        return out[0].transpose(1, 2), out[1]
    return out.transpose(1, 2)


def init_self_attn_cache(
    batch: int, max_len: int, n_heads: int, head_dim: int, dtype, device
) -> Cache:
    """Self-attention KV cache for incremental decoding, head-major
    [B,H,max_len,D]; ``index`` is the number of positions already written
    (a host integer here; a caller may put a tensor in its place)."""
    shape = (batch, n_heads, max_len, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": 0,
    }


def _read_kv(x, dtype: torch.dtype) -> torch.Tensor:
    """A cached cross-attention K or V in ``dtype``: an int8 ``QTensor``
    (``models/quant.quantize_kv_cache``) is dequantized on read, as the
    JAX layer does; a tensor in the model dtype is read as it is."""
    return x.dequantize(dtype) if isinstance(x, QTensor) else x


def is_vector_index(index) -> bool:
    """Whether a self cache's ``index`` is a per-sequence [B] tensor."""
    return isinstance(index, torch.Tensor) and index.ndim == 1


def positions(table: torch.Tensor, cache: Optional[list], qlen: int) -> torch.Tensor:
    """A decoder's positional rows for ``qlen`` tokens: from 0 without a
    cache; from the self cache's index, clamped so the slice fits
    (``dynamic_slice``), for a scalar index (a host integer, or a 0-dim
    tensor read on the device); and for a [B] index each sequence's own
    rows, clipped to the table ([B, Q, D])."""
    if cache is None:
        return table[:qlen]
    idx = cache[0]["self"]["index"]
    if is_vector_index(idx):
        pos_ids = idx[:, None] + torch.arange(qlen, device=idx.device)[None, :]
        return table[pos_ids.clamp(0, table.shape[0] - 1)]
    if isinstance(idx, torch.Tensor):
        start = idx.clamp(0, table.shape[0] - qlen)
        return table.index_select(0, start + torch.arange(qlen, device=idx.device))
    start = max(0, min(int(idx), table.shape[0] - qlen))
    return table[start:start + qlen]


# projection names of one attention layer: OpenAI Whisper's, fairseq's
# (the AV-HuBERT encoder) or ESPnet's (the Auto-AVSR decoder)
_PROJ_NAMES = {
    "whisper": ("query", "key", "value", "out"),
    "fairseq": ("q_proj", "k_proj", "v_proj", "out_proj"),
    "espnet": ("linear_q", "linear_k", "linear_v", "linear_out"),
}


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention with an optional KV cache.

    * full sequence: ``mha(x)`` or ``mha(x, kv_src=enc)`` runs the
      flash-attention kernel (causal when ``causal``; keys past
      ``kv_lengths[b]`` masked when given);
    * incremental self-attention: ``mha(x, cache=c)`` with
      ``c = {"k", "v", "index"}`` writes x's K/V at ``index`` and attends
      causally over the cached prefix; ``index`` is a host integer, a
      0-dim tensor on the device (the same, with no host read, so a CUDA
      graph can replay the step), or a [B] tensor that puts each sequence
      at its own offset;
    * cross-attention with ``cache={"k", "v"}`` from :meth:`precompute_kv`
      (or its int8 ``QTensor`` form, dequantized on read).
    ``mask`` (broadcast to [B, H, Q, K], True = attend) joins the causal
    mask of the incremental path, masks the cached cross-attention, and
    sends the full-sequence path down the unfused masked attention, as in
    JAX (``layers.py:311-323``): the AV-HuBERT decoder's cross-attention
    onto a padded encoder output takes that path.
    Returns ``(out, new_cache)``; ``new_cache`` is None without a cache.
    The key projection has a bias only with ``use_k_bias`` (AV-HuBERT's
    has one, Whisper's not); ``names`` picks the projections' state-dict
    names ("whisper": query/key/value/out, "fairseq": q/k/v/out_proj,
    "espnet": linear_q/k/v/out).
    In training with ``attn_dropout > 0`` the full-sequence path drops
    attention weights and so runs unfused, with neither the causal mask
    nor ``kv_lengths``: the JAX layer (``layers.py:301-310``) passes
    neither to that path, so padded keys are attended in training there.
    ``kv_dim`` is the width of what the keys and values are projected from
    (``d_model`` when None), which a flax ``Dense`` infers from its input:
    a decoder's cross-attention onto a narrower encoder.
    ``capture``: None, or a list to which the full-sequence cross-attention
    path appends its fp32 [B,H,Q,K] weights, computed unfused for that
    (``decode/word_timestamps.py`` sets it around an alignment forward).
    """

    def __init__(self, d_model: int, n_heads: int, dtype=torch.bfloat16, device=None,
                 param_dtype=None, use_k_bias: bool = False, names: str = "whisper",
                 attn_dropout: float = 0.0, kv_dim: Optional[int] = None):
        super().__init__()
        self.d_model, self.n_heads = d_model, n_heads
        self.head_dim = d_model // n_heads
        self.attn_dropout = attn_dropout
        kw = dict(device=device, param_dtype=param_dtype or dtype, compute_dtype=dtype)
        self._proj_names = _PROJ_NAMES[names]
        self.capture: Optional[list] = None
        kv_dim = kv_dim or d_model
        for name, bias, d_in in zip(self._proj_names, (True, use_k_bias, True, True),
                                    (d_model, kv_dim, kv_dim, d_model)):
            self.add_module(name, CastLinear(d_in, d_model, bias=bias, **kw))

    def _proj(self, i: int) -> CastLinear:
        """The i-th projection: 0 query, 1 key, 2 value, 3 output."""
        return self._modules[self._proj_names[i]]

    @property
    def local_heads(self) -> int:
        """Heads this rank computes: every head, or ``n_heads / mp`` under
        tensor parallelism (the rows of the query weight it holds)."""
        return self._proj(0).weight.shape[0] // self.head_dim

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, H*D] -> [B, T, H, D]: every head, or this model rank's
        ``n_heads / mp`` under tensor parallelism."""
        b, t, _ = x.shape
        return x.view(b, t, -1, self.head_dim)

    def precompute_kv(self, kv_src: torch.Tensor) -> Cache:
        """Cross-attention K/V for the decode loop: the model-dtype
        projections, laid out head-major [B,H,T,D] once here."""
        return {
            "k": self._split(self._proj(1)(kv_src)).transpose(1, 2).contiguous(),
            "v": self._split(self._proj(2)(kv_src)).transpose(1, 2).contiguous(),
        }

    def _vector_index_step(self, x, q, cache: Cache, mask):
        """The incremental self-attention with a [B] ``index`` tensor (each
        sequence at its own offset, as speculative decoding leaves them):
        query ``t`` of sequence ``b`` writes row ``index[b] + t``, and
        positions at or beyond the buffer are dropped (JAX's
        ``mode="drop"`` scatter), and each sequence attends causally up to
        its own offset. Only the Q new rows are scattered: a dropped query
        is sent to the last row with the value that row ends up holding,
        so every duplicate index writes the same value. Rows past a
        sequence's index hold stale K/V of rejected drafts; they are never
        attended and are overwritten later."""
        idx = cache["index"]
        b, qlen = x.shape[:2]
        max_len, head_dim = cache["k"].shape[2], cache["k"].shape[3]
        pos_ids = torch.arange(max_len, device=x.device)
        q_ids = torch.arange(qlen, device=x.device)
        row = (idx[:, None] + q_ids[None, :]).clamp(max=max_len - 1)  # [B, Q] row written
        src = row - idx[:, None]  # the query whose K/V lands in that row; < 0: none, keep it
        fresh = (src >= 0)[:, None, :, None]
        shape = (b, self.local_heads, qlen, head_dim)
        row = row[:, None, :, None].expand(shape)
        src = src.clamp(min=0)[:, None, :, None].expand(shape)
        for name, i in (("k", 1), ("v", 2)):
            new = self._split(self._proj(i)(x)).transpose(1, 2).to(cache[name].dtype)
            value = torch.where(fresh, new.gather(2, src), cache[name].gather(2, row))
            cache[name].scatter_(2, row, value)
        attn_mask = (pos_ids[None, None, :] <= q_ids[None, :, None] + idx[:, None, None])[:, None]
        if mask is not None:
            attn_mask = attn_mask & mask
        out = head_major_attention(q.transpose(1, 2), cache["k"], cache["v"], attn_mask)
        return out.transpose(1, 2), {"k": cache["k"], "v": cache["v"], "index": idx + qlen}

    def forward(
        self,
        x: torch.Tensor,
        kv_src: Optional[torch.Tensor] = None,
        cache: Optional[Cache] = None,
        causal: bool = False,
        kv_lengths: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        mask: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[Cache]]:
        if current_sequence_split() is not None:
            if cache is not None or kv_src is not None:
                raise NotImplementedError("sequence parallelism splits self-attention blocks "
                                          "without a cache only")
            x = seq_enter(x, self._proj(0))
        q = self._split(self._proj(0)(x))
        new_cache = None
        if cache is not None and is_vector_index(cache.get("index")):
            out, new_cache = self._vector_index_step(x, q, cache, mask)
        elif cache is not None and "index" in cache:
            idx = cache["index"]
            qlen, max_len = x.shape[1], cache["k"].shape[2]
            # dynamic_update_slice semantics: the start clamps so the
            # update fits inside the buffer
            if isinstance(idx, torch.Tensor):  # 0-dim, on the device: the host reads nothing
                rows = idx.clamp(0, max_len - qlen) + torch.arange(qlen, device=x.device)
                for name, i in (("k", 1), ("v", 2)):
                    new = self._split(self._proj(i)(x)).transpose(1, 2).to(cache[name].dtype)
                    cache[name].index_copy_(2, rows, new)
            else:
                idx = int(idx)
                start = max(0, min(idx, max_len - qlen))
                for name, i in (("k", 1), ("v", 2)):
                    cache[name][:, :, start:start + qlen] = \
                        self._split(self._proj(i)(x)).transpose(1, 2)
            pos_ids = torch.arange(max_len, device=x.device)[None, :]
            q_ids = torch.arange(qlen, device=x.device)[:, None]
            attn_mask = (pos_ids <= q_ids + idx)[None, None]
            if mask is not None:
                attn_mask = attn_mask & mask
            new_cache = {"k": cache["k"], "v": cache["v"], "index": idx + qlen}
            out = head_major_attention(q.transpose(1, 2), cache["k"], cache["v"], attn_mask)
            out = out.transpose(1, 2)
        elif cache is not None:
            out = head_major_attention(q.transpose(1, 2), _read_kv(cache["k"], q.dtype),
                                       _read_kv(cache["v"], q.dtype), mask)
            out = out.transpose(1, 2)
            new_cache = cache
        else:
            src = x if kv_src is None else kv_src
            k = self._split(self._proj(1)(src))
            v = self._split(self._proj(2)(src))
            if self.training and self.attn_dropout > 0.0:
                out = dot_product_attention(q, k, v, mask, dropout_rate=self.attn_dropout,
                                            generator=generator,
                                            split=self._proj(0).output_split(1))
            elif self.capture is not None and kv_src is not None:
                out, weights = dot_product_attention(q, k, v, mask, return_weights=True)
                tp = self._proj(0).tp
                # every head's weights, as one device holds them
                self.capture.append(weights if tp is None else
                                    gather_from_group(weights, tp[1], 1))
            elif mask is None:
                out = fused_attention(q, k, v, lengths=kv_lengths, causal=causal)
            else:
                out = dot_product_attention(q, k, v, mask)
        b, t = out.shape[:2]
        return seq_leave(self._proj(3)(out.reshape(b, t, -1)), self._proj(3)), new_cache


class MLP(nn.Sequential):
    """fc1 -> exact GELU -> dropout (training only) -> fc2, named ``mlp.0``
    / ``mlp.2`` as in Whisper."""

    def __init__(self, d_model: int, d_ff: int, dtype=torch.bfloat16, device=None,
                 param_dtype=None, dropout: float = 0.0):
        kw = dict(device=device, param_dtype=param_dtype or dtype, compute_dtype=dtype)
        super().__init__(
            CastLinear(d_model, d_ff, **kw), nn.GELU(), CastLinear(d_ff, d_model, **kw)
        )
        self.dropout = dropout

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = residual_dropout(self[1](self[0](seq_enter(x, self[0]))), self.dropout,
                             self.training, generator, self[0].output_split(-1))
        return seq_leave(self[2](h), self[2])


# state-dict names of a block's self-attention, its norm, the MLP norm, the
# cross-attention and its norm: OpenAI Whisper's, or fairseq's (AV-HuBERT,
# whose MLP is ``fc1``/``fc2`` on the block itself instead of
# ``mlp.0``/``mlp.2``)
_BLOCK_NAMES = {
    "whisper": ("attn", "attn_ln", "mlp_ln", "cross_attn", "cross_attn_ln"),
    "fairseq": ("self_attn", "self_attn_layer_norm", "final_layer_norm", "encoder_attn",
                "encoder_attn_layer_norm"),
}


def tanh_gate(gate: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``tanh`` of an fp32 gate in fp32, cast to the activation dtype."""
    return torch.tanh(gate.float()).to(dtype)


class TransformerBlock(nn.Module):
    """Pre-norm (or post-norm) block: self-attention [+ cross-attention] +
    MLP, with dropout at ``dropout`` on each sublayer's output before the
    residual add, ``attention_dropout`` on every attention's weights and
    ``activation_dropout`` inside every MLP (in training only).
    ``self_mask`` and ``enc_mask`` (True = attend) are the self- and
    cross-attention's ``mask``.

    ``gated_x_attn`` adds the Whisper-Flamingo sublayers on a second
    context stream ``xv`` (or the ``"xv"`` cache entry) *before* the
    others: ``x_attn_ln`` -> ``x_attn`` -> ``x + tanh(x_attn_gate) * delta``,
    then ``x_mlp_ln`` -> ``x_mlp`` -> ``x + tanh(x_mlp_gate) * delta``, with
    fp32 gates of shape [1], zero at initialisation; their deltas get no
    residual dropout (``layers.py:431-437``). ``kv_lengths`` masks
    the self-attention's keys past each row's length. ``names`` picks the
    state-dict names of the self- and cross-attention, their norms and the
    MLP (see ``_BLOCK_NAMES``); the gated sublayers keep Whisper's.
    ``cross_kv_dim`` is the width of the cross-attention's context
    (``d_model`` when None). ``n_experts > 0`` puts a
    :class:`~avsl_tpu_torch.models.moe.MoEFFN` (``moe_top_k``,
    ``moe_capacity_factor``) in the MLP's place, as the module ``mlp``
    under either naming; with ``kv_lengths`` the positions past each row's
    length neither route nor enter its balance loss (``layers.py:474-481``).
    ``seq_split`` (a :class:`~avsl_tpu_torch.core.mesh.SequenceSplit`)
    runs the block under sequence parallelism: ``x`` is this model rank's
    slice of T, and so is the output; attention and an MoE FFN (whose
    routing is one device's) see the whole sequence (key lengths are
    global), and the layer norms, residual dropout and residual run on
    the slice.
    """

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
        gated_x_attn: bool = False,
        pre_norm: bool = True,
        use_k_bias: bool = False,
        names: str = "whisper",
        attention_dropout: float = 0.0,
        activation_dropout: float = 0.0,
        cross_kv_dim: Optional[int] = None,
        n_experts: int = 0,
        moe_top_k: int = 2,
        moe_capacity_factor: float = 1.25,
    ):
        super().__init__()
        self.causal_self_attn = causal_self_attn
        self.pre_norm = pre_norm
        self.dropout = dropout
        self.activation_dropout = activation_dropout
        self.names = names
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        mha = dict(kw, use_k_bias=use_k_bias, attn_dropout=attention_dropout)
        attn, attn_ln, mlp_ln, cross, cross_ln = _BLOCK_NAMES[names]
        self._sub_names = {"attn": attn, "attn_ln": attn_ln, "mlp_ln": mlp_ln,
                           "cross": cross, "cross_ln": cross_ln}
        self.add_module(attn, MultiHeadAttention(d_model, n_heads, names=names, **mha))
        self.add_module(attn_ln, LayerNormF32(d_model, device=device))
        self.has_cross_attn = has_cross_attn
        if has_cross_attn:
            self.add_module(cross, MultiHeadAttention(d_model, n_heads, names=names,
                                                      kv_dim=cross_kv_dim, **mha))
            self.add_module(cross_ln, LayerNormF32(d_model, device=device))
        self.gated_x_attn = gated_x_attn
        if gated_x_attn:
            self.x_attn = MultiHeadAttention(d_model, n_heads, **mha)
            self.x_attn_ln = LayerNormF32(d_model, device=device)
            self.x_attn_gate = nn.Parameter(torch.empty(1, device=device, dtype=torch.float32))
            self.x_mlp = MLP(d_model, d_ff, dropout=activation_dropout, **kw)
            self.x_mlp_ln = LayerNormF32(d_model, device=device)
            self.x_mlp_gate = nn.Parameter(torch.empty(1, device=device, dtype=torch.float32))
        self.n_experts = n_experts
        if n_experts > 0:
            from avsl_tpu_torch.models.moe import MoEFFN

            self.mlp = MoEFFN(d_model, d_ff, n_experts, top_k=moe_top_k,
                              capacity_factor=moe_capacity_factor, **kw)
        elif names == "fairseq":
            lin = dict(device=device, param_dtype=param_dtype or dtype, compute_dtype=dtype)
            self.fc1 = CastLinear(d_model, d_ff, **lin)
            self.fc2 = CastLinear(d_ff, d_model, **lin)
        else:
            self.mlp = MLP(d_model, d_ff, dropout=activation_dropout, **kw)
        self.add_module(mlp_ln, LayerNormF32(d_model, device=device))

    def _sub(self, role: str) -> nn.Module:
        return self._modules[self._sub_names[role]]

    @property
    def cross(self) -> MultiHeadAttention:
        """The cross-attention, under either naming."""
        return self._sub("cross")

    def _ffn(self, h: torch.Tensor, generator: Optional[torch.Generator],
             kv_lengths: Optional[torch.Tensor]) -> torch.Tensor:
        if self.n_experts > 0:
            # the routing runs over the whole T (one device's); every model
            # rank then holds the whole output and keeps its slice
            split = current_sequence_split()
            h = h if split is None else split.gather(h)
            valid = None
            if kv_lengths is not None:
                valid = (torch.arange(h.shape[1], device=h.device)[None, :]
                         < kv_lengths.to(h.device)[:, None])
            y = self.mlp(h, valid=valid)
            return y if split is None else split.scatter(y)
        if self.names == "fairseq":
            h = F.gelu(self.fc1(seq_enter(h, self.fc1)))
            h = self.fc2(residual_dropout(h, self.activation_dropout, self.training, generator,
                                          self.fc1.output_split(-1)))
            return seq_leave(h, self.fc2)
        return self.mlp(h, generator)

    def _residual(self, x, delta, generator):
        split = current_sequence_split()
        return x + residual_dropout(delta, self.dropout, self.training, generator,
                                    None if split is None else split.draw_split())

    def _sublayer(self, x, ln, fn, generator):
        """``x + dropout(fn(ln(x)))`` pre-norm, ``ln(x + dropout(fn(x)))`` post-norm."""
        if self.pre_norm:
            return self._residual(x, fn(ln(x)), generator)
        return ln(self._residual(x, fn(x), generator))

    def forward(
        self,
        x: torch.Tensor,
        enc: Optional[torch.Tensor] = None,
        cache: Optional[Cache] = None,
        generator: Optional[torch.Generator] = None,
        xv: Optional[torch.Tensor] = None,
        kv_lengths: Optional[torch.Tensor] = None,
        self_mask: Optional[torch.Tensor] = None,
        enc_mask: Optional[torch.Tensor] = None,
        seq_split=None,
    ) -> Tuple[torch.Tensor, Optional[Cache]]:
        with sequence_split_scope(seq_split):
            return self._forward(x, enc, cache, generator, xv, kv_lengths, self_mask, enc_mask)

    def _forward(self, x, enc, cache, generator, xv, kv_lengths, self_mask, enc_mask):
        new_cache: Optional[Cache] = {} if cache is not None else None

        xv_cache = None if cache is None else cache.get("xv")
        if self.gated_x_attn and (xv is not None or xv_cache is not None):
            delta, c = self.x_attn(self.x_attn_ln(x), kv_src=xv, cache=xv_cache,
                                   generator=generator)
            x = x + tanh_gate(self.x_attn_gate, x.dtype) * delta
            delta = self.x_mlp(self.x_mlp_ln(x), generator)
            x = x + tanh_gate(self.x_mlp_gate, x.dtype) * delta
            if new_cache is not None:
                new_cache["xv"] = c if c is not None else xv_cache

        def self_attn(h):
            out, c = self._sub("attn")(
                h, cache=None if cache is None else cache.get("self"),
                causal=self.causal_self_attn and cache is None, kv_lengths=kv_lengths,
                generator=generator, mask=self_mask,
            )
            if new_cache is not None:
                new_cache["self"] = c
            return out

        x = self._sublayer(x, self._sub("attn_ln"), self_attn, generator)
        if self.has_cross_attn and (enc is not None or (cache or {}).get("cross")):
            def cross_attn(h):
                out, c = self.cross(
                    h, kv_src=enc, cache=None if cache is None else cache.get("cross"),
                    generator=generator, mask=enc_mask)
                if new_cache is not None:
                    new_cache["cross"] = c
                return out

            x = self._sublayer(x, self._sub("cross_ln"), cross_attn, generator)
        x = self._sublayer(x, self._sub("mlp_ln"), lambda h: self._ffn(h, generator, kv_lengths),
                           generator)
        return x, new_cache
