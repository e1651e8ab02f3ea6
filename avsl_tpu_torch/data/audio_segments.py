"""WAV ingest: integer PCM to float32, wav loading at a target rate, and
noise mixing at a set SNR.

Port of ``pcm_to_float``, ``load_wav``, ``write_wav`` and ``add_noise``
from ``avsl_tpu/data/audio_segments.py``. A wav at another rate is
resampled on the host CPU (``kernels/resample.py``).
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
    """Read a wav to mono float32 in [-1, 1] at ``target_sr``."""
    import scipy.io.wavfile as wavfile

    sr, data = wavfile.read(path)
    data = pcm_to_float(data)
    if sr != target_sr:
        from avsl_tpu_torch.kernels.resample import resample_poly

        data = resample_poly(data, sr, target_sr).numpy()
    return data


def write_wav(path: str, audio: np.ndarray, sr: int = 16000) -> str:
    import scipy.io.wavfile as wavfile

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    wavfile.write(path, sr, (np.clip(audio, -1, 1) * 32767).astype(np.int16))
    return path


def add_noise(clean: np.ndarray, noise: np.ndarray, snr_db: float, rng=None) -> np.ndarray:
    """Mix ``noise`` into ``clean`` at ``snr_db`` dB: a random window of the
    (tiled) noise scaled to the target RMS, in float64, the mix divided by
    its peak when that exceeds 1. ``rng`` is a numpy Generator."""
    rng = np.random.default_rng() if rng is None else rng
    if len(noise) < len(clean):
        noise = np.tile(noise, int(np.ceil(len(clean) / len(noise))))
    start = rng.integers(0, len(noise) - len(clean) + 1)
    noise = noise[start : start + len(clean)].astype(np.float64)
    clean64 = clean.astype(np.float64)
    clean_rms = np.sqrt(np.mean(clean64**2)) + 1e-12
    noise_rms = np.sqrt(np.mean(noise**2)) + 1e-12
    target_noise_rms = clean_rms / (10.0 ** (snr_db / 20.0))
    mixed = clean64 + noise * (target_noise_rms / noise_rms)
    peak = np.max(np.abs(mixed))
    if peak > 1.0:
        mixed = mixed / peak
    return mixed.astype(np.float32)
