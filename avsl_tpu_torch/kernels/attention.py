"""Fused (flash-style) attention: the hand-written Hopper kernels
``csrc/flash_attn_fwd.cu`` (forward) and ``csrc/flash_attn_bwd.cu``
(backward) and their plain PyTorch versions. Their bf16 bodies run on
the tensor cores (``wgmma`` on TMA-fed tiles); their fp32 bodies stay on
the FMA pipes.

Port of ``avsl_tpu/kernels/attention.py``: ``reference_attention`` is the
plain version of ``_reference_attention``, ``reference_attention_bwd``
the plain version of ``_attn_bwd_kernel``, and ``fused_attention`` is the
public entry (layout [B, T, H, D]). When a gradient is wanted,
``fused_attention`` goes through a ``torch.autograd.Function`` (the JAX
``custom_vjp``): on CUDA tensors its forward launches the forward kernel,
which then also writes the row statistics, and its backward launches the
backward kernel; on CPU tensors the same Function runs the plain forward
and the plain backward. On a CUDA tensor each wrapper launches its kernel
or raises, with no fallback. ``fused_attention.launches`` and
``fused_attention_bwd.launches`` count kernel launches.

Without a gradient, ``fused_attention`` calls the forward through the
custom op ``torch.ops.avsl_tpu_torch.flash_attn_fwd`` (with a fake
implementation for tracing), so ``torch.export`` captures the
hand-written kernel as one node of a serving program instead of failing
on its ctypes call; the op launches the kernel on CUDA tensors and runs
:func:`reference_attention` on CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1.0e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# head dims each body takes, the same for the bf16 tensor-core bodies and
# the fp32 FMA bodies: 16 (the tiny_test configs'), 32, 64 and 128 (the
# AV-HuBERT decoder's)
_HEAD_DIMS = {torch.float32: (16, 32, 64, 128), torch.bfloat16: (16, 32, 64, 128)}

# The kernels' accuracy contract against the plain versions below, elementwise
# |got - want| <= atol + rtol * |want|. K1 and K2 in bf16:
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
# K1 in fp32:
FP32_TOL = dict(atol=1e-4, rtol=0.0)
# K2 in fp32: both sum up to Tq or Tk fp32 products, in other orders, and
# the kernel's weights come from the forward's online m and l
BWD_FP32_TOL = dict(atol=1e-4, rtol=1e-4)
# K1's row statistics against the plain row max and sum: fp32 sums in other
# orders
STATS_TOL = dict(atol=1e-5, rtol=1e-5)
# K2's bf16 bodies round P and dS to bf16 (relative error at most 2^-9
# each) before their fp32-accumulated products, so an element of dV = P^T dO
# can be off by 2^-9 sum_q |P||dO| (dQ and dK likewise over |dS|), which
# passes BF16_TOL's atol where many query rows attend to few keys (a key
# length of 2 under a causal mask over 100 rows). The causal-with-lengths
# and D = 128 cases add 2^-8 times that magnitude sum to the limit.
BF16_MAGNITUDE = 2.0 ** -8

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _masked_logits(
    q: torch.Tensor, k: torch.Tensor, lengths: Optional[torch.Tensor], causal: bool
) -> torch.Tensor:
    """[B,H,Tq,Tk] fp32 scaled logits with the kernels' masking: masked
    positions take the finite ``NEG_INF``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    tq, tk = q.shape[2], k.shape[2]
    if causal:
        q_ids = torch.arange(tq, device=q.device)[:, None]
        k_ids = torch.arange(tk, device=q.device)[None, :]
        logits = torch.where((k_ids <= q_ids)[None, None], logits, NEG_INF)
    if lengths is not None:
        k_ids = torch.arange(tk, device=q.device)
        valid = k_ids[None, :] < lengths.to(q.device)[:, None]  # [B, Tk]
        logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    return logits


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor],
    causal: bool,
) -> torch.Tensor:
    """[B,H,Tq,D] attention with an fp32 softmax: the semantic spec.

    Masked logits take the finite ``NEG_INF``, so a row with no valid key
    gets uniform weights; normalised weights are cast to ``q.dtype``
    before the PV product, which accumulates in fp32."""
    weights = torch.softmax(_masked_logits(q, k, lengths, causal), dim=-1).to(q.dtype)
    return torch.matmul(weights.float(), v.float()).to(q.dtype)


def reference_attention_stats(
    q: torch.Tensor, k: torch.Tensor, lengths: Optional[torch.Tensor], causal: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row statistics the forward kernel writes for the backward, over
    [B,H,T,D] operands: ``m`` the row max of the scaled, masked logits and
    ``l`` the row sum of ``exp(logits - m)``, both fp32 [B,H,Tq]."""
    logits = _masked_logits(q, k, lengths, causal)
    m = logits.amax(dim=-1)
    return m, torch.exp(logits - m[..., None]).sum(dim=-1)


def reference_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lengths: Optional[torch.Tensor],
    causal: bool,
) -> Grads:
    """Plain version of the backward kernel over [B,H,T,D] operands:
    ``(dq, dk, dv)`` in the input dtypes.

    Whole-row fp32 recompute of the weights P, ``delta = rowsum(fp32(dO) *
    fp32(O))``, ``dS = P * (dO V^T - delta) / sqrt(D)`` at every in-range
    key, ``dQ = dS K``, ``dK = dS^T Q``, ``dV = P^T dO``. This is what the
    TPU kernel computes, not autograd of :func:`reference_attention`: on a
    row with key length 0 (uniform weights) it forms dS at every key, so
    its dQ and dK differ there from autograd's zeros."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(_masked_logits(q, k, lengths, causal), dim=-1)
    g = do.float()
    dv = torch.matmul(p.transpose(-1, -2), g)
    dp = torch.matmul(g, v.float().transpose(-1, -2))
    delta = (g * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _library(name: str, argtypes):
    from avsl_tpu_torch.kernels._build import load_library

    fn = getattr(load_library(name), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_FWD_ARGTYPES = (
    [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 9
    + [ctypes.c_float, ctypes.c_int]
    + [ctypes.c_void_p] * 3
)
_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 12
    + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 15
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)


def _check_operands(named, dtype, device) -> None:
    for name, t in named:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {dtype}")
        if t.ndim != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be 4-D [B,T,H,D] with a contiguous last dim")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"flash attention takes float32 or bfloat16, got {dtype}")


def _check_tma(named) -> None:
    """The bf16 kernels read their operands by TMA, which takes only base
    addresses and strides (of dimensions longer than 1) that are multiples
    of 16 bytes. Raise on anything else: there is no other bf16 path."""
    for name, t in named:
        if t.dtype != torch.bfloat16:
            continue
        strides = [t.stride(i) * t.element_size() for i in range(3) if t.shape[i] > 1]
        if t.data_ptr() % 16 or any(s % 16 for s in strides):
            raise ValueError(
                f"{name}: bf16 operands need a 16-byte aligned base and [B,T,H] strides "
                f"of multiples of 16 bytes (TMA); got address {t.data_ptr()} and strides "
                f"{tuple(t.stride())[:3]} elements")


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    b, _, h, d = q.shape
    dims = _HEAD_DIMS[q.dtype]
    if d not in dims:
        raise ValueError(f"flash attention in {q.dtype} takes head dims {dims}, got {d}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if k.shape[1] < 1:
        raise ValueError("flash attention needs at least one key")


def _device_lengths(lengths: Optional[torch.Tensor], b: int, device) -> Optional[torch.Tensor]:
    if lengths is None:
        return None
    lengths = lengths.to(device=device, dtype=torch.int32).contiguous()
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be [B]={b}, got {tuple(lengths.shape)}")
    return lengths


def _strides(*tensors: torch.Tensor):
    return [s for t in tensors for s in (t.stride(0), t.stride(1), t.stride(2))]


def flash_attention_fwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    causal: bool = False,
    stats: bool = False,
):
    """Launch the forward kernel on CUDA tensors [B,Tq,H,D], [B,Tk,H,D] x2.
    With ``stats`` it also returns the row statistics ``(out, m, l)``
    (fp32 [B,H,Tq]) that the backward kernel reads; without, only ``out``
    and the kernel writes none. Raises on anything the kernel does not take."""
    _check_operands((("q", q), ("k", k), ("v", v)), q.dtype, q.device)
    _check_shapes(q, k, v)
    _check_tma((("q", q), ("k", k), ("v", v)))
    b, tq, h, d = q.shape
    tk = k.shape[1]
    lengths = _device_lengths(lengths, b, q.device)
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    m = l = None
    if stats:
        m = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    if tq > 0 and b > 0 and h > 0:
        fn = _library("flash_attn_fwd", _FWD_ARGTYPES)
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lengths is None else lengths.data_ptr(),
            b, h, tq, tk, d, _DTYPE_CODES[q.dtype], *_strides(q, k, v),
            1.0 / math.sqrt(d), int(bool(causal)),
            None if m is None else m.data_ptr(), None if l is None else l.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"flash_attn_fwd launch failed: cudaError {rc}")
        fused_attention.launches += 1
    return (out, m, l) if stats else out


def flash_attention_bwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> Grads:
    """Launch the backward kernel on CUDA tensors: Q/O/dO [B,Tq,H,D], K/V
    [B,Tk,H,D], and the forward's fp32 row statistics ``m``/``l``
    [B,H,Tq]. Returns contiguous ``(dq, dk, dv)`` in the input dtype.
    Raises on anything the kernel does not take."""
    _check_operands((("q", q), ("k", k), ("v", v), ("o", o), ("do", do)), q.dtype, q.device)
    _check_shapes(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o/do shapes {tuple(o.shape)}/{tuple(do.shape)} != q {tuple(q.shape)}")
    _check_tma((("q", q), ("k", k), ("v", v), ("do", do)))
    b, tq, h, d = q.shape
    tk = k.shape[1]
    for name, t in (("m", m), ("l", l)):
        if (t.device != q.device or t.dtype != torch.float32 or t.shape != (b, h, tq)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 [B,H,Tq] on {q.device}")
    lengths = _device_lengths(lengths, b, q.device)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((b, tk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if tq == 0 or b == 0 or h == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    fn = _library("flash_attn_bwd", _BWD_ARGTYPES)
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        m.data_ptr(), l.data_ptr(), delta.data_ptr(),
        None if lengths is None else lengths.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, tq, tk, d, _DTYPE_CODES[q.dtype], *_strides(q, k, v, o, do),
        1.0 / math.sqrt(d), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attn_bwd launch failed: cudaError {rc}")
    fused_attention_bwd.launches += 1
    return dq, dk, dv


def _head_major(*tensors: torch.Tensor):
    return [t.transpose(1, 2) for t in tensors]


def fused_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    causal: bool = False,
    m: Optional[torch.Tensor] = None,
    l: Optional[torch.Tensor] = None,
) -> Grads:
    """Backward of :func:`fused_attention`, layout [B, T, H, D]: the kernel
    on CUDA tensors (which needs the forward's ``m`` and ``l``), the plain
    version on CPU tensors."""
    if q.device.type == "cuda":
        if m is None or l is None:
            raise ValueError("the backward kernel needs the forward's row statistics m and l")
        return flash_attention_bwd_cuda(q, k, v, o, do, m, l, lengths, causal)
    if q.device.type != "cpu":
        raise ValueError(f"fused_attention_bwd runs on cuda or cpu, got {q.device}")
    grads = reference_attention_bwd(*_head_major(q, k, v, o, do), lengths, causal)
    dq, dk, dv = _head_major(*grads)
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """``fused_attention`` with a gradient: kernels on CUDA tensors, plain
    versions on CPU tensors (the JAX package's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, causal):
        m = l = None
        if q.device.type == "cuda":
            out, m, l = flash_attention_fwd_cuda(q, k, v, lengths, causal, stats=True)
        else:
            out = _head_major(reference_attention(*_head_major(q, k, v), lengths, causal))[0]
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lengths, m, l)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lengths, m, l = ctx.saved_tensors
        dq, dk, dv = fused_attention_bwd(q, k, v, out, do, lengths, ctx.causal, m, l)
        return dq, dk, dv, None, None


@torch.library.custom_op("avsl_tpu_torch::flash_attn_fwd", mutates_args=())
def flash_attn_fwd_op(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor],
    causal: bool,
) -> torch.Tensor:
    """The forward without row statistics, layout [B, Tq, H, D], as a
    custom op: the kernel on CUDA tensors, the plain version (contiguous,
    as the kernel writes it) on CPU tensors."""
    if q.device.type == "cuda":
        return flash_attention_fwd_cuda(q, k, v, lengths, causal)
    return _head_major(reference_attention(*_head_major(q, k, v), lengths, causal))[0].contiguous()


@flash_attn_fwd_op.register_fake
def _(q, k, v, lengths, causal):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Public entry, layout [B, Tq, H, D]: the kernel on CUDA tensors, the
    plain version on CPU tensors. Differentiable in q, k and v; only when
    a gradient is wanted does the forward kernel write row statistics."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_attention runs on cuda or cpu, got {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FusedAttention.apply(q, k, v, lengths, causal)
    return flash_attn_fwd_op(q, k, v, lengths, causal)


fused_attention.launches = 0
fused_attention_bwd.launches = 0
