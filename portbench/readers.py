"""What the per-layer readers in ``metrics/`` share. Each takes the
reader context (``trace``, ``window``, ``launches``, ``peaks``) and the
``kind`` of window it reads (``train`` or ``transcribe``), and returns
None when it finds nothing to read there."""

from __future__ import annotations

from portbench import flops

# K1's and K2's kernels, by the names the trace gives them
ATTN_KERNELS = r"\b(flash_fwd_\w+|bwd_wgmma|dkdv_fma|dq_fma|delta_kernel)$"


def _window(ctx, kind):
    win = ctx["window"]
    return win if ctx["trace"] is not None and win.get("kind") == kind else None


def idle_share(ctx, kind):
    """100 x (1 - union of the device's kernel, copy and set intervals /
    the traced window)."""
    tr = ctx["trace"]
    if _window(ctx, kind) is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def launches_per(ctx, kind, unit):
    """Device kernels launched in the traced window over the window's
    ``unit`` (``segments`` trained or ``tokens`` served)."""
    win = _window(ctx, kind)
    if win is None or not win.get(unit):
        return None
    return ctx["trace"].kernels / win[unit]


def mfu(ctx, kind):
    """The whole step's share of the card's bf16 peak: the model
    operations of the work the window completed (``flops.py``, from
    shapes) over the window's seconds times the peak."""
    win = _window(ctx, kind)
    if win is None or not win.get("model_ops"):
        return None
    return 100.0 * win["model_ops"] / (win["seconds"] * ctx["peaks"]["bf16_flops"])


def attn_roofline(ctx, kind):
    """K1 and K2's share of their roofline: for every launch the least
    time the card could take (its operations over the peak of its dtype,
    or its bytes over the HBM bandwidth, whichever is longer;
    ``flops.kernel_launch``), summed, over the device time of the
    flash-attention kernels in the trace."""
    peaks = ctx["peaks"]
    if _window(ctx, kind) is None or not ctx["launches"]:
        return None
    seconds = ctx["trace"].seconds_matching(ATTN_KERNELS)
    if seconds <= 0:
        return None
    bound = 0.0
    for l in ctx["launches"]:
        c = flops.kernel_launch(l["kind"], l["b"], l["h"], l["tq"], l["tk"], l["d"],
                                l["itemsize"], l["causal"], l["lengths"])
        peak = peaks["bf16_flops"] if l["itemsize"] == 2 else peaks["fp32_flops"]
        bound += max(c["ops"] / peak, c["bytes"] / peaks["hbm_bytes_per_s"])
    return 100.0 * bound / seconds
