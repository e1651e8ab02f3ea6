"""Whisper-Flamingo fine-tuning CLI of the port: for now only the
synthetic dataset that ``whisper_ft --smoke`` trains on.

Port of ``avsl_tpu/cli/finetune.py::make_synthetic_dataset``. The
Flamingo fine-tuning entry point itself needs the video slice
(ROADMAP.md queue 1, item 8), and ``load_datasets`` the host data layer
(item 13).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np


def make_synthetic_dataset(n: int = 8, seconds: float = 1.0) -> List[Dict[str, Any]]:
    """Miniature in-memory dataset for --smoke (no AMI data needed)."""
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        sr = 16000
        audio = (0.1 * rng.standard_normal(int(seconds * sr))).astype(np.float32)
        rows.append(
            {
                "audio": {"array": audio, "sampling_rate": sr},
                "transcript": f"synthetic utterance number {i}",
                "duration": seconds,
                "lip_video": None,
            }
        )
    return rows
