"""Whisper's log-mel spectrogram and LibriSpeech SpecAugment, plain.

The log-mel follows openai/whisper ``audio.py``: 16 kHz, a periodic Hann
window of 400 taps, hop 160, ``torch.stft`` with reflect centre padding,
the power of every frame but the last, Slaney mel filters (librosa's
``filters.mel(htk=False, norm="slaney")``, written out here), log10
clamped at 1e-10 and at the item's maximum less 8, then ``(x + 4) / 4``.

SpecAugment draws, from an explicit generator and in this order, per
frequency mask a width ``U{0..27}`` for every item then a start
``floor(u * max(n_mels - width, 1))`` from a float64 uniform, then per
time mask a width ``U{0..100}`` capped at the item's frames and a start
``floor(u * max(frames - width, 1))``; masked cells take the item's mean
(the LibriSpeech basic policy, one mask of each kind, as the training
YAML names it). The harness gives this and the program one generator
seed, so both draw the same masks.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
F_MAX = 27
T_MAX = 100


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep, mels)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=4)
def mel_filters(n_mels: int = 80, sr: int = SAMPLE_RATE, n_fft: int = N_FFT) -> np.ndarray:
    """[n_mels, n_fft // 2 + 1] float32 Slaney-normalised triangles."""
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    weights = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        lower = (fft_freqs - mel_f[i]) / (mel_f[i + 1] - mel_f[i])
        upper = (mel_f[i + 2] - fft_freqs) / (mel_f[i + 2] - mel_f[i + 1])
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(np.float32)


def log_mel(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """audio [B, samples] float32 -> [B, n_mels, samples // 160] float32."""
    window = torch.hann_window(N_FFT, periodic=True, device=audio.device, dtype=torch.float32)
    spec = torch.stft(audio.float(), N_FFT, HOP, window=window, center=True, pad_mode="reflect",
                      return_complex=True)
    power = spec[..., :-1].abs() ** 2
    filters = torch.from_numpy(mel_filters(n_mels)).to(audio.device)
    mel = torch.matmul(filters, power)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0


def spec_augment(mel: torch.Tensor, frames: torch.Tensor, generator: torch.Generator,
                 n_freq: int = 1, n_time: int = 1) -> torch.Tensor:
    """mel [B, n_mels, T] with ``n_freq`` frequency and ``n_time`` time
    masks an item, drawn as the module docstring says; ``frames`` [B] the
    unpadded 100 Hz frames of each item."""
    b, n_mels, t_len = mel.shape
    dev = mel.device
    frames = frames.to(dev, torch.int64).clamp(max=t_len)

    def below(hi):
        u = torch.rand(hi.shape, generator=generator, device=dev, dtype=torch.float64)
        return torch.minimum((u * hi).floor().long(), hi - 1)

    bands, spans = [], []
    for _ in range(n_freq):
        w = torch.randint(0, F_MAX + 1, (b,), generator=generator, device=dev)
        bands.append((w, below((n_mels - w).clamp(min=1))))
    for _ in range(n_time):
        w = torch.minimum(torch.randint(0, T_MAX + 1, (b,), generator=generator, device=dev),
                          frames)
        spans.append((w, below((frames - w).clamp(min=1))))
    f_ids = torch.arange(n_mels, device=dev)[None, :]
    t_ids = torch.arange(t_len, device=dev)[None, :]
    fmask = torch.zeros((b, n_mels), dtype=torch.bool, device=dev)
    tmask = torch.zeros((b, t_len), dtype=torch.bool, device=dev)
    for w, s in bands:
        fmask |= (f_ids >= s[:, None]) & (f_ids < (s + w)[:, None])
    for w, s in spans:
        tmask |= (t_ids >= s[:, None]) & (t_ids < (s + w)[:, None])
    mask = fmask[:, :, None] | tmask[:, None, :]
    mean = mel.mean(dim=(1, 2), keepdim=True)
    return torch.where(mask, mean, mel)
