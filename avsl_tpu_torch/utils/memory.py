"""Device-memory telemetry.

Port of ``avsl_tpu/utils/memory.py`` over PyTorch's per-device memory
statistics: ``get_memory_stats`` reads each visible CUDA device's bytes
in use, peak and total (``torch.cuda.memory_allocated``,
``max_memory_allocated``, ``mem_get_info``) and the host's memory from
/proc; ``estimate_model_memory`` counts a model's parameters;
``memory_aware_batch_size`` clamps a batch to the device's free memory.
Without a card the device entries are absent and the batch clamp returns
the request.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

_GB = 1024 ** 3


def get_memory_stats() -> Dict[str, float]:
    """Per-device and host memory in GB, as a flat dict for metric logs:
    ``device{i}_bytes_in_use_gb``, ``device{i}_peak_bytes_gb`` (since the
    last ``reset_peak_memory_stats``) and ``device{i}_limit_gb`` for each
    CUDA device, ``system_total_gb`` and ``system_available_gb``."""
    stats: Dict[str, float] = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats[f"device{i}_bytes_in_use_gb"] = torch.cuda.memory_allocated(i) / _GB
            stats[f"device{i}_peak_bytes_gb"] = torch.cuda.max_memory_allocated(i) / _GB
            stats[f"device{i}_limit_gb"] = torch.cuda.mem_get_info(i)[1] / _GB
    try:
        with open("/proc/meminfo") as f:
            info = {line.split(":")[0]: line.split()[1] for line in f if ":" in line}
        stats["system_total_gb"] = float(info.get("MemTotal", 0)) / 1024 ** 2
        stats["system_available_gb"] = float(info.get("MemAvailable", 0)) / 1024 ** 2
    except OSError:
        pass
    return stats


def estimate_model_memory(model: torch.nn.Module, optimizer_copies: int = 2,
                          activation_multiplier: float = 1.5,
                          param_bytes: int = 4) -> Dict[str, float]:
    """Parameter-count estimate in GB: parameters, gradients, optimizer
    state (Adam's two moments) and a rough activation allowance."""
    n_params = sum(p.numel() for p in model.parameters())
    p = n_params * param_bytes / _GB
    return {
        "n_params": float(n_params),
        "params_gb": p,
        "grads_gb": p,
        "optimizer_gb": p * optimizer_copies,
        "activations_gb_est": p * activation_multiplier,
        "total_gb_est": p * (2 + optimizer_copies + activation_multiplier),
    }


def memory_aware_batch_size(requested: int, per_item_gb: float, reserve_gb: float = 2.0,
                            device: Optional[torch.device] = None) -> int:
    """``requested`` clamped to the items of ``per_item_gb`` that fit in
    the device's free memory less ``reserve_gb`` (at least 1); the
    request as it is without a CUDA device."""
    if not torch.cuda.is_available():
        return requested
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    if device.type != "cuda":
        return requested
    free = torch.cuda.mem_get_info(device)[0] / _GB
    fit = int(max(free - reserve_gb, 0.0) // max(per_item_gb, 1e-6))
    return max(min(requested, fit), 1)
