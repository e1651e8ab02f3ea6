"""WAV ingest and audio segmentation: integer PCM to float32, wav loading
at a target rate, slicing every segment of a source wav loaded once,
noise mixing at a set SNR, and audio/video length alignment.

Port of ``avsl_tpu/data/audio_segments.py``. A wav at another rate is
resampled on the host CPU (``kernels/resample.py``).
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

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


def slice_segment(audio: np.ndarray, start: float, end: float, sr: int = 16000) -> np.ndarray:
    """Samples ``[round(start sr), round(end sr))`` of ``audio``, clipped to it."""
    i0 = max(int(round(start * sr)), 0)
    i1 = min(int(round(end * sr)), len(audio))
    return audio[i0:i1]


def batch_segment_audio(
    source_path: str,
    segments: Sequence,
    output_dir: str,
    sr: int = 16000,
    overwrite: bool = False,
) -> List[Tuple[bool, str]]:
    """Slice every segment (``segment_id``, ``start``, ``end``) of one source
    wav, loaded once, to ``{output_dir}/{segment_id}.wav``. Returns one
    ``(success, path)`` a segment; an empty slice or a failed write is
    ``(False, path)``."""
    os.makedirs(output_dir, exist_ok=True)
    audio = load_wav(source_path, sr)
    results: List[Tuple[bool, str]] = []
    for seg in segments:
        out = os.path.join(output_dir, f"{seg.segment_id}.wav")
        try:
            if overwrite or not os.path.exists(out):
                clip = slice_segment(audio, seg.start, seg.end, sr)
                if len(clip) == 0:
                    results.append((False, out))
                    continue
                write_wav(out, clip, sr)
            results.append((True, out))
        except Exception:
            results.append((False, out))
    return results


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


def align_audio_video_lengths(
    audio_feats: np.ndarray, video_feats: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Truncate both feature streams to the shorter length (frames axis 0),
    the reference's alignment rule."""
    t = min(len(audio_feats), len(video_feats))
    return audio_feats[:t], video_feats[:t]
