"""SpecAugment (LibriSpeech basic / double policies) on the device.

Port of ``avsl_tpu/kernels/specaugment.py`` as plain torch ops, split in
two: :func:`draw_spec_augment` draws each item's mask widths and starts
from an explicit ``torch.Generator``, and :func:`apply_spec_augment` masks
the mel batch with given draws, so a test can feed the apply the draws
that JAX makes from its key. The generators differ, so the port's masks
are not JAX's masks; their distribution is.

Policy constants follow the SpecAugment paper's LibriSpeech settings:
F=27 max mel bins per frequency mask, T=100 max frames per time mask,
time masks confined to the first ``audio_frames`` (the unpadded region).
Masked cells take the item's spectrogram mean.
"""

from __future__ import annotations

import torch

F_MAX = 27
T_MAX = 100


def _below(hi: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One uniform integer in [0, hi) per element of ``hi`` (hi >= 1)."""
    u = torch.rand(hi.shape, generator=generator, device=hi.device, dtype=torch.float64)
    return torch.minimum((u * hi).floor().long(), hi - 1)


def draw_spec_augment(
    audio_frames: torch.Tensor,
    n_mels: int,
    t_len: int,
    generator: torch.Generator,
    n_freq_mask: int = 2,
    n_time_mask: int = 2,
    f_max: int = F_MAX,
    t_max: int = T_MAX,
) -> torch.Tensor:
    """Mask draws for a batch: int64 [B, n_freq_mask + n_time_mask, 2] of
    (width, start), frequency masks first, drawn on ``audio_frames``'
    device. As in JAX: width ~ U{0..f_max}, start ~ U[0, max(n_mels -
    width, 1)); time width ~ U{0..t_max} capped at the item's frames
    (``min(audio_frames, t_len)``), start ~ U[0, max(frames - width, 1))."""
    frames = audio_frames.to(torch.int64).clamp(max=t_len)
    b, dev = frames.shape[0], frames.device
    draws = []
    for _ in range(n_freq_mask):
        f = torch.randint(0, f_max + 1, (b,), generator=generator, device=dev)
        draws.append(torch.stack([f, _below((n_mels - f).clamp(min=1), generator)], -1))
    for _ in range(n_time_mask):
        t = torch.randint(0, t_max + 1, (b,), generator=generator, device=dev)
        t = torch.minimum(t, frames)
        draws.append(torch.stack([t, _below((frames - t).clamp(min=1), generator)], -1))
    if not draws:
        return torch.zeros((b, 0, 2), dtype=torch.int64, device=dev)
    return torch.stack(draws, 1)


def apply_spec_augment(mel: torch.Tensor, draws: torch.Tensor, n_freq_mask: int) -> torch.Tensor:
    """Mask time-major ``mel`` [B, T, n_mels] with ``draws`` from
    :func:`draw_spec_augment`: the first ``n_freq_mask`` rows of each
    item's draws are frequency bands, the rest time spans; masked cells
    take the item's mean over the whole spectrogram."""
    b, t_len, n_mels = mel.shape
    mean = mel.mean(dim=(1, 2), keepdim=True)
    width, start = draws[..., 0][..., None], draws[..., 1][..., None]  # [B, M, 1]
    freq_ids = torch.arange(n_mels, device=mel.device)
    time_ids = torch.arange(t_len, device=mel.device)
    freq = ((freq_ids >= start[:, :n_freq_mask]) & (freq_ids < start[:, :n_freq_mask]
                                                    + width[:, :n_freq_mask])).any(1)
    time = ((time_ids >= start[:, n_freq_mask:]) & (time_ids < start[:, n_freq_mask:]
                                                    + width[:, n_freq_mask:])).any(1)
    mask = freq[:, None, :] | time[:, :, None]  # [B, T, n_mels]
    return torch.where(mask, mean, mel)


def spec_augment_batch(
    mel: torch.Tensor,
    generator: torch.Generator,
    audio_frames: torch.Tensor,
    n_freq_mask: int = 2,
    n_time_mask: int = 2,
) -> torch.Tensor:
    """Draw and apply over a batch: mel [B, T, n_mels], audio_frames [B]."""
    draws = draw_spec_augment(
        audio_frames, mel.shape[2], mel.shape[1], generator, n_freq_mask, n_time_mask
    )
    return apply_spec_augment(mel, draws, n_freq_mask)
