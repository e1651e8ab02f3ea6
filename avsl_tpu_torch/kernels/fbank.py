"""AV-HuBERT audio features in PyTorch: 26-dim log filterbank -> stack-4 ->
104-dim, plus the MFCC and delta features of the HuBERT clustering recipe.

Port of ``avsl_tpu/kernels/fbank.py`` (``logfbank``, ``stack_frames``,
``frame_normalize``, ``mfcc``, ``add_deltas``, ``avhubert_audio_features``),
the ``python_speech_features.logfbank`` defaults: pre-emphasis 0.97, 25 ms
rectangular frames at a 10 ms hop, the 512-point real-DFT power spectrum
scaled by 1/512, the HTK filterbank with integer-bin corners, an exact
zero floored to fp32 eps, the natural log; then consecutive-frame
stacking with zero tail padding and a per-frame mean/std normalisation
over the feature axis.

The JAX package frames and transforms in one strided fp32 convolution
over the rectangular-window DFT basis (400 samples inside a 512-point
transform). Here the same basis multiplies the ``unfold``-ed frames in
one fp32 matmul, which computes the same sums: cuDNN would run an fp32
convolution in TF32 by default, while an fp32 matmul stays in fp32 (as in
``kernels/logmel.py``).
"""

from __future__ import annotations

import functools
import math
from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

from avsl_tpu_torch.core.device import resolve_device
from avsl_tpu_torch.kernels.mel import mel_filterbank_htk_psf

SAMPLE_RATE = 16000
WINLEN = 0.025
WINSTEP = 0.01
NFILT = 26
NFFT = 512
PREEMPH = 0.97

Audio = Union[np.ndarray, torch.Tensor]


@functools.lru_cache(maxsize=4)
def _psf_dft_filters(frame_len: int, nfft: int) -> np.ndarray:
    """Rectangular-window real-DFT basis ``[frame_len, 2*n_bins]`` of an
    ``nfft``-point transform over ``frame_len`` samples (the frames are
    implicitly zero-padded to nfft): cos columns, then -sin."""
    n_bins = nfft // 2 + 1
    n = np.arange(frame_len, dtype=np.float64)
    k = np.arange(n_bins, dtype=np.float64)[:, None]
    angle = 2.0 * np.pi * k * n[None, :] / nfft
    filt = np.concatenate([np.cos(angle), -np.sin(angle)], axis=0).astype(np.float32)
    return np.ascontiguousarray(filt.T)


@functools.lru_cache(maxsize=4)
def _psf_fbank(nfilt: int, nfft: int, sr: int) -> np.ndarray:
    return mel_filterbank_htk_psf(nfilt=nfilt, nfft=nfft, samplerate=sr).astype(np.float32)


def _num_frames(n_samples: int, frame_len: int, frame_step: int) -> int:
    # python_speech_features.sigproc.framesig frame count
    if n_samples <= frame_len:
        return 1
    return 1 + int(math.ceil((n_samples - frame_len) / frame_step))


def _on_device(audio: Audio, device) -> torch.Tensor:
    """A tensor stays where it is; a numpy array goes to ``device``."""
    if isinstance(audio, torch.Tensor):
        return audio
    return torch.as_tensor(np.asarray(audio, np.float32), device=resolve_device(device))


def logfbank(
    audio: Audio,
    samplerate: int = SAMPLE_RATE,
    nfilt: int = NFILT,
    nfft: int = NFFT,
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """Log mel filterbank energies, ``[T, nfilt]`` (or ``[B, T, nfilt]``),
    fp32. A numpy input goes to ``device``."""
    x = _on_device(audio, device).to(torch.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    frame_len = int(round(WINLEN * samplerate))
    frame_step = int(round(WINSTEP * samplerate))
    n_frames = _num_frames(x.shape[1], frame_len, frame_step)
    # pre-emphasis: y[0] = x[0]; y[i] = x[i] - 0.97 x[i-1]
    x = torch.cat([x[:, :1], x[:, 1:] - PREEMPH * x[:, :-1]], dim=1)
    # zero-pad so the frames are exactly python_speech_features' count
    x = F.pad(x, (0, frame_len + (n_frames - 1) * frame_step - x.shape[1]))
    frames = x.unfold(-1, frame_len, frame_step)  # [B, n_frames, frame_len]
    basis = torch.from_numpy(_psf_dft_filters(frame_len, nfft)).to(x.device)
    spec = torch.matmul(frames, basis)  # [B, n_frames, 2*n_bins]
    n_bins = nfft // 2 + 1
    real, imag = spec[..., :n_bins], spec[..., n_bins:]
    pspec = (real * real + imag * imag) / nfft
    fb = torch.from_numpy(_psf_fbank(nfilt, nfft, samplerate)).to(x.device)
    feat = torch.matmul(pspec, fb.T)  # [B, T, nfilt]
    feat = torch.where(feat == 0.0, torch.finfo(torch.float32).eps, feat)
    out = torch.log(feat)  # natural log, the python_speech_features convention
    return out[0] if squeeze else out


def stack_frames(feats: torch.Tensor, stack_order: int = 4) -> torch.Tensor:
    """Concatenate ``stack_order`` consecutive frames, zero-padding the
    tail: [T, F] -> [ceil(T/stack), stack*F], batched input likewise."""
    if stack_order <= 1:
        return feats
    squeeze = feats.ndim == 2
    if squeeze:
        feats = feats[None]
    b, t, f = feats.shape
    feats = F.pad(feats, (0, 0, 0, (-t) % stack_order))
    out = feats.reshape(b, -1, stack_order * f)
    return out[0] if squeeze else out


def frame_normalize(feats: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-frame mean/std normalisation over the feature axis (the
    population std)."""
    mean = feats.mean(dim=-1, keepdim=True)
    std = feats.std(dim=-1, keepdim=True, unbiased=False)
    return (feats - mean) / (std + eps)


def mfcc(
    audio: Audio,
    samplerate: int = SAMPLE_RATE,
    numcep: int = 13,
    nfilt: int = 26,
    nfft: int = NFFT,
    ceplifter: int = 22,
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """MFCCs (python_speech_features conventions, no energy term): the
    ortho DCT-II of the log filterbank energies, the first ``numcep``
    coefficients, sinusoidal liftering. ``[T, numcep]`` (or batched)."""
    feats = logfbank(audio, samplerate=samplerate, nfilt=nfilt, nfft=nfft, device=device)
    squeeze = feats.ndim == 2
    if squeeze:
        feats = feats[None]
    n = np.arange(nfilt)
    k = np.arange(numcep)
    dct = 2.0 * np.cos(np.pi * k[None, :] * (2 * n[:, None] + 1) / (2 * nfilt))
    scale = np.full((1, numcep), np.sqrt(1.0 / (2 * nfilt)))
    scale[0, 0] = np.sqrt(1.0 / (4 * nfilt))
    dct = torch.from_numpy((dct * scale).astype(np.float32)).to(feats.device)
    out = torch.matmul(feats, dct)
    if ceplifter > 0:
        lift = 1.0 + (ceplifter / 2.0) * torch.sin(
            math.pi * torch.arange(numcep, device=feats.device, dtype=torch.float32) / ceplifter)
        out = out * lift
    return out[0] if squeeze else out


def add_deltas(feats: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Append delta and delta-delta features ([..., T, F] -> [..., T, 3F]):
    regression deltas over ``window`` frames each side with the edge frames
    replicated."""
    denom = 2.0 * sum(i * i for i in range(1, window + 1))

    def delta(x: torch.Tensor) -> torch.Tensor:
        t = x.shape[-2]
        idx = torch.arange(-window, t + window, device=x.device).clamp(0, t - 1)
        xp = x.index_select(-2, idx)  # edge replication
        acc = torch.zeros_like(x)
        for i in range(1, window + 1):
            acc = acc + i * (xp.narrow(-2, window + i, t) - xp.narrow(-2, window - i, t))
        return acc / denom

    d = delta(feats)
    return torch.cat([feats, d, delta(d)], dim=-1)


def avhubert_audio_features(
    audio: Audio,
    samplerate: int = SAMPLE_RATE,
    stack_order: int = 4,
    normalize: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """The AV-HuBERT audio path: logfbank -> stack -> normalise (104-dim)."""
    feats = stack_frames(logfbank(audio, samplerate=samplerate, device=device), stack_order)
    return frame_normalize(feats) if normalize else feats
