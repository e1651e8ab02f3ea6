"""Model assembly: audio-only Whisper(-Flamingo), built on the device.

Port of ``avsl_tpu/models/factory.py::build_whisper_flamingo`` for
``add_gated_x_attn=0``, for serving and for training. The gated video
cross-attention and its AV-HuBERT video tower belong to a later slice and
raise here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from avsl_tpu_torch.core.config import WhisperConfig
from avsl_tpu_torch.core.device import resolve_device
from avsl_tpu_torch.models.whisper import Whisper


def build_whisper_flamingo(
    model_name: str = "large-v2",
    vocab_size: Optional[int] = None,
    add_gated_x_attn: int = 1,
    use_av_hubert_encoder: bool = True,
    dropout_rate: float = 0.0,
    dtype: str = "bfloat16",
    param_dtype: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
) -> Tuple[Whisper, WhisperConfig]:
    """Build the Whisper model on ``device`` with random weights from a
    ``torch.Generator`` seeded with ``seed``; returned in eval mode.

    ``model_name`` accepts the Whisper presets plus "test" (miniature);
    ``vocab_size`` overrides the preset vocab. ``add_gated_x_attn=1``
    raises until slice 3; ``use_av_hubert_encoder`` only matters with it.
    ``dtype`` is the compute dtype and ``param_dtype`` the dtype the
    weights are stored in (``dtype`` when None: serving casts nothing).
    Training passes ``param_dtype="float32"`` for fp32 weights and Adam
    state under bf16 compute, and ``dropout_rate`` for the residual
    dropout that ``model.train()`` turns on. The JAX factory's ``remat``
    options are not taken (no activation checkpointing in the port yet).
    """
    dev = resolve_device(device)
    if model_name == "test":
        w_cfg = WhisperConfig.tiny_test(dtype=dtype)
    else:
        w_cfg = WhisperConfig.from_name(model_name, dtype=dtype)
    overrides: dict = {
        "add_gated_x_attn": int(add_gated_x_attn),
        "dropout_rate": float(dropout_rate),
        "param_dtype": param_dtype or dtype,
    }
    if vocab_size is not None:
        overrides["n_vocab"] = int(vocab_size)
    w_cfg = dataclasses.replace(w_cfg, **overrides)
    model = Whisper(w_cfg, device="meta").materialize(dev, seed=seed)
    return model.eval(), w_cfg
