"""Quantiles with ``jax.numpy``'s arithmetic.

``jnp.median``/``jnp.nanmedian`` take the midpoint of the two middle values
of an even count (``torch.median`` returns the lower one), and
``jnp.quantile``'s linear method weighs the two neighbours as ``low * (1 -
w) + high * w`` in float32 with ``w = q * (n - 1) - floor(q * (n - 1))``.
The lip frontend's decisions (window offsets truncated to int32, the
top-decile mask of the detector) sit on these values, so the port computes
them the same way.
"""

from __future__ import annotations

import torch


def quantile(x: torch.Tensor, q: float, dim: int = -1, method: str = "linear",
             ignore_nan: bool = False) -> torch.Tensor:
    """The ``q`` quantile of ``x`` along ``dim`` (removed), float32.

    ``method`` is ``"linear"`` or ``"midpoint"``. With ``ignore_nan`` NaNs
    are left out (all-NaN gives NaN); without it any NaN makes the result
    NaN, as in ``jnp.quantile``."""
    if method not in ("linear", "midpoint"):
        raise ValueError(f"method {method!r}")
    x = x.float().movedim(dim, -1)
    if ignore_nan:
        s = torch.sort(x, dim=-1).values  # NaN sorts last
        counts = (~torch.isnan(s)).sum(dim=-1).float()
    else:
        x = torch.where(torch.isnan(x).any(dim=-1, keepdim=True), float("nan"), x)
        s = torch.sort(x, dim=-1).values
        counts = torch.full(x.shape[:-1], float(x.shape[-1]), device=x.device)
    pos = torch.tensor(q, dtype=torch.float32, device=x.device) * (counts - 1)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    low = torch.maximum(torch.zeros_like(low), torch.minimum(low, counts - 1)).long()
    high = torch.maximum(torch.zeros_like(high), torch.minimum(high, counts - 1)).long()
    low_v = torch.gather(s, -1, low[..., None])[..., 0]
    high_v = torch.gather(s, -1, high[..., None])[..., 0]
    if method == "midpoint":
        return (low_v + high_v) * 0.5
    return low_v * low_w + high_v * high_w


def median(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.median`` along ``dim``: the midpoint of an even count."""
    return quantile(x, 0.5, dim, method="midpoint")


def nanmedian(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.nanmedian`` along ``dim``."""
    return quantile(x, 0.5, dim, method="midpoint", ignore_nan=True)


def nanquantile(x: torch.Tensor, q: float, dim: int = -1) -> torch.Tensor:
    """``jnp.nanquantile`` (linear) along ``dim``."""
    return quantile(x, q, dim, method="linear", ignore_nan=True)
