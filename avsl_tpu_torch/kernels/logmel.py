"""Whisper log-mel spectrogram in PyTorch.

Port of ``avsl_tpu/kernels/logmel.py`` (``pad_or_trim``,
``log_mel_spectrogram``). Same constants and steps: 16 kHz audio, n_fft
400, hop 160, reflect centre padding, periodic Hann window, |.|^2 of all
but the last frame, Slaney mel filters, log10 clamped to [max-8, max] per
sample, then (x+4)/4.

The windowed real DFT is a framed fp32 matmul: ``unfold`` cuts the padded
signal into hop-strided frames and one matmul against the Hann-windowed
cos/-sin basis gives the real and imaginary parts. It is not an fp32
``conv1d``, because cuDNN runs fp32 convolutions in TF32 by default, and
fp32 matmuls stay in full fp32 unless ``allow_tf32`` is set.
"""

from __future__ import annotations

import functools
from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

from avsl_tpu_torch.core.device import resolve_device
from avsl_tpu_torch.kernels.mel import mel_filterbank_slaney

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000


def pad_or_trim(
    array: Union[np.ndarray, torch.Tensor], length: int = N_SAMPLES, axis: int = -1
):
    """Pad with zeros or trim to exactly ``length`` along ``axis``."""
    n = array.shape[axis]
    if n > length:
        idx = [slice(None)] * array.ndim
        idx[axis] = slice(0, length)
        return array[tuple(idx)]
    if n < length:
        if isinstance(array, torch.Tensor):
            axis = axis % array.ndim
            shape = list(array.shape)
            shape[axis] = length - n
            return torch.cat([array, array.new_zeros(shape)], dim=axis)
        pad = [(0, 0)] * array.ndim
        pad[axis] = (0, length - n)
        return np.pad(array, pad)
    return array


@functools.lru_cache(maxsize=8)
def _dft_basis(n_fft: int) -> np.ndarray:
    """Hann-windowed real-DFT basis ``[n_fft, 2*n_bins]``: the first n_bins
    columns are cos (real part), the next n_bins are -sin (imaginary)."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))  # periodic Hann
    k = np.arange(n_bins, dtype=np.float64)[:, None]
    angle = 2.0 * np.pi * k * n[None, :] / n_fft
    basis = np.concatenate(
        [np.cos(angle) * window[None, :], -np.sin(angle) * window[None, :]], axis=0
    )
    return np.ascontiguousarray(basis.T.astype(np.float32))


@functools.lru_cache(maxsize=8)
def _mel_matrix(n_mels: int, n_fft: int, sr: int) -> np.ndarray:
    return mel_filterbank_slaney(sr=sr, n_fft=n_fft, n_mels=n_mels)


def log_mel_spectrogram(
    audio: Union[np.ndarray, torch.Tensor],
    n_mels: int = 80,
    padding: int = 0,
    n_fft: int = N_FFT,
    hop_length: int = HOP_LENGTH,
    sample_rate: int = SAMPLE_RATE,
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """Whisper log-mel: ``[n_mels, T]`` for 1-D input, ``[B, n_mels, T]``
    batched, fp32. ``padding`` appends that many zero samples first.
    A numpy input goes to ``device`` (a tensor stays where it is)."""
    if not isinstance(audio, torch.Tensor):
        audio = torch.as_tensor(np.asarray(audio, np.float32), device=resolve_device(device))
    audio = audio.to(torch.float32)
    squeeze = audio.ndim == 1
    if squeeze:
        audio = audio[None]
    if padding > 0:
        audio = F.pad(audio, (0, padding))
    pad = n_fft // 2
    x = F.pad(audio[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop_length)  # [B, n_frames, n_fft]
    basis = torch.from_numpy(_dft_basis(n_fft)).to(audio.device)
    spec = torch.matmul(frames, basis)  # [B, n_frames, 2*n_bins]
    n_bins = n_fft // 2 + 1
    real, imag = spec[..., :n_bins], spec[..., n_bins:]
    power = (real * real + imag * imag)[:, :-1]  # whisper drops the final frame
    mel_mat = torch.from_numpy(_mel_matrix(n_mels, n_fft, sample_rate)).to(audio.device)
    mel = torch.matmul(power, mel_mat.T).transpose(1, 2)  # [B, n_mels, T]
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    # dynamic-range clamp is per sample (whisper computes it per item)
    max_per_sample = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, max_per_sample - 8.0)
    out = (log_spec + 4.0) / 4.0
    return out[0] if squeeze else out
