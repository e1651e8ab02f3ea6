"""The arithmetic of a reference: fp32 with TF32 off, or, for the control
that a comparison has to fail, fp8 e4m3 operands at every product.

``Precision.mm(x, w)`` is ``x @ w.T`` and ``Precision.op(t)`` rounds an
operand of a product (an activation, a weight, a convolution input).
Under ``fp8`` every operand is scaled per tensor to the e4m3 range,
rounded to e4m3 and scaled back, and the gradient that flows back through
it is rounded to e5m2 the same way: the recipe of fp8 training.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((t.float() / scale).to(dtype).float() * scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


class Precision:
    """``name``: "fp32" (the reference) or "fp8" (its control)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}: 'fp32' or 'fp8'")
        self.name = name

    def op(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.name == "fp32" else _Fp8.apply(t)

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.op(x), self.op(w).transpose(-1, -2))

    def bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.op(a), self.op(b))


def exact_fp32() -> None:
    """fp32 products in fp32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
