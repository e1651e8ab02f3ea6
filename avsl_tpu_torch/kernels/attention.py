"""Fused (flash-style) attention forward: the hand-written Hopper kernel
``csrc/flash_attn_fwd.cu`` and its plain PyTorch version.

Port of ``avsl_tpu/kernels/attention.py``: ``reference_attention`` is the
plain version of ``_reference_attention`` and ``fused_attention`` is the
public wrapper (layout [B, T, H, D]). On a CPU tensor the wrapper runs the
plain version; on a CUDA tensor it launches the kernel or raises, with no
fallback. ``fused_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1.0e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)


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
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(weights.float(), v.float()).to(q.dtype)


def _library():
    from avsl_tpu_torch.kernels._build import load_library

    lib = load_library("flash_attn_fwd")
    fn = lib.flash_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors [B,Tq,H,D], [B,Tk,H,D] x2.
    Raises on anything the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.ndim != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be 4-D [B,T,H,D] with a contiguous last dim")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention_fwd takes float32 or bfloat16, got {q.dtype}")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd takes head dim {_HEAD_DIMS}, got {d}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if tk < 1:
        raise ValueError("flash_attention_fwd needs at least one key")
    if lengths is not None:
        lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
        if lengths.shape != (b,):
            raise ValueError(f"lengths must be [B]={b}, got {tuple(lengths.shape)}")
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    if tq == 0 or b == 0 or h == 0:
        return out
    fn = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lengths is None else lengths.data_ptr(),
        b, h, tq, tk, d, _DTYPE_CODES[q.dtype],
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        1.0 / math.sqrt(d), int(bool(causal)), stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: cudaError {rc}")
    fused_attention.launches += 1
    return out


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Public entry, layout [B, Tq, H, D]: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if q.device.type == "cuda":
        return flash_attention_fwd_cuda(q, k, v, lengths, causal)
    if q.device.type != "cpu":
        raise ValueError(f"fused_attention runs on cuda or cpu, got {q.device}")
    out = reference_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), lengths, causal
    )
    return out.transpose(1, 2)


fused_attention.launches = 0
