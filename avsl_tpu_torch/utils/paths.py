"""Path helpers: the project root, directory checks, checkpoint and log
paths, disk usage. Port of ``avsl_tpu/utils/paths.py``."""

from __future__ import annotations

import os
import shutil
from typing import Dict


def project_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def check_writable(path: str) -> bool:
    probe_dir = path if os.path.isdir(path) else os.path.dirname(path) or "."
    if not os.path.isdir(probe_dir):
        return False
    probe = os.path.join(probe_dir, ".write_probe")
    try:
        with open(probe, "w") as f:
            f.write("x")
        os.remove(probe)
        return True
    except OSError:
        return False


def get_checkpoint_path(base_dir: str, train_id: str, name: str = "") -> str:
    path = os.path.join(base_dir, train_id, name) if name else os.path.join(base_dir, train_id)
    return ensure_dir(path)


def get_log_path(base_dir: str, train_id: str) -> str:
    return ensure_dir(os.path.join(base_dir, train_id))


def disk_usage_report(path: str = ".") -> Dict[str, float]:
    usage = shutil.disk_usage(path)
    gb = 1024 ** 3
    return {
        "total_gb": usage.total / gb,
        "used_gb": usage.used / gb,
        "free_gb": usage.free / gb,
        "used_pct": 100.0 * usage.used / usage.total,
    }


def log_disk_space(path: str = ".", print_fn=print) -> Dict[str, float]:
    rep = disk_usage_report(path)
    print_fn(f"disk [{os.path.abspath(path)}]: {rep['free_gb']:.1f} GB free / "
             f"{rep['total_gb']:.1f} GB ({rep['used_pct']:.0f}% used)")
    return rep
