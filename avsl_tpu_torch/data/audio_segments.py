"""WAV ingest: integer PCM to float32 and 16 kHz wav loading.

Port of ``pcm_to_float``, ``load_wav`` and ``write_wav`` from
``avsl_tpu/data/audio_segments.py``. Resampling waits for the port of
``kernels/resample.py``: a wav at another rate raises.
"""

from __future__ import annotations

import os

import numpy as np


def pcm_to_float(data: np.ndarray) -> np.ndarray:
    """Integer PCM -> float32 in [-1, 1]; mono-mix stereo; float passes
    through."""
    data = np.asarray(data)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if data.dtype == np.int16:
        return data.astype(np.float32) / 32768.0
    if data.dtype == np.int32:
        return data.astype(np.float32) / 2147483648.0
    if data.dtype == np.uint8:  # wav uint8 is offset-binary
        return (data.astype(np.float32) - 128.0) / 128.0
    return data.astype(np.float32)


def load_wav(path: str, target_sr: int = 16000) -> np.ndarray:
    """Read a wav to mono float32 in [-1, 1]; its rate must be ``target_sr``."""
    import scipy.io.wavfile as wavfile

    sr, data = wavfile.read(path)
    if sr != target_sr:
        raise NotImplementedError(
            f"{path}: sample rate {sr} != {target_sr}; resampling waits for the "
            "port of kernels/resample.py (ROADMAP.md queue 1, item 7)"
        )
    return pcm_to_float(data)


def write_wav(path: str, audio: np.ndarray, sr: int = 16000) -> str:
    import scipy.io.wavfile as wavfile

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    wavfile.write(path, sr, (np.clip(audio, -1, 1) * 32767).astype(np.int16))
    return path
