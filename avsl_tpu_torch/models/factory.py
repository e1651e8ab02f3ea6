"""Model assembly, built on the device: Whisper(-Flamingo) with an
AV-HuBERT video encoder, AV-HuBERT with its seq2seq or CTC head, and
Auto-AVSR's audio-visual Conformer (``build_auto_avsr``, which
``cli/auto_avsr_ft.py`` trains).

Port of ``avsl_tpu/models/factory.py`` (``make_av_hubert_video_encoder``
and ``build_whisper_flamingo``), for serving and for training, plus the
builders of the two AV-HuBERT heads that ``cli/avhubert_ft.py`` trains,
of the pretraining model ``cli/pretrain.py`` trains and of the bare
encoder ``cli/extract.py`` taps (the JAX CLIs construct
``AVHuBERTForSpeech2Text`` / ``AVHuBERTForCTC`` /
``AVHuBERTForPretraining`` / ``AVHuBERTModel`` themselves).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple, Union

import torch

from avsl_tpu_torch.core.config import AutoAVSRConfig, AVHuBERTConfig, WhisperConfig
from avsl_tpu_torch.core.device import resolve_device
from avsl_tpu_torch.models.avhubert import (
    AVHuBERTForCTC,
    AVHuBERTForSpeech2Text,
    AVHuBERTModel,
    init_weights,
)
from avsl_tpu_torch.models.conformer import AutoAVSR
from avsl_tpu_torch.models.pretrain import AVHuBERTForPretraining
from avsl_tpu_torch.models.whisper import Whisper


def make_av_hubert_video_encoder(av_cfg: AVHuBERTConfig, device=None) -> AVHuBERTModel:
    """The AV-HuBERT trunk run video-only as the Flamingo video encoder
    (``use_audio=False``, ``modality_fuse="add"``); its config is ``.cfg``.
    It is called as ``(video=, padding_mask=, deterministic=,
    use_running_average=, generator=)``, the JAX encoder's ``(video, mask,
    deterministic, use_running_average)`` plus the generator its training
    draws come from."""
    cfg = dataclasses.replace(av_cfg, use_audio=False, modality_fuse="add")
    return AVHuBERTModel(cfg, device=device)


def build_whisper_flamingo(
    model_name: str = "large-v2",
    vocab_size: Optional[int] = None,
    add_gated_x_attn: int = 1,
    use_av_hubert_encoder: bool = True,
    av_hubert_cfg: Optional[AVHuBERTConfig] = None,
    dropout_rate: float = 0.0,
    dtype: str = "bfloat16",
    param_dtype: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
    remat: bool = False,
    remat_policy: str = "block",
) -> Tuple[Whisper, WhisperConfig]:
    """Build the Whisper(+Flamingo) model on ``device`` with random weights
    from a ``torch.Generator`` seeded with ``seed``; returned in eval mode.

    ``model_name`` accepts the Whisper presets plus "test" (miniature,
    with ``AVHuBERTConfig.tiny_test`` as the video tower unless
    ``av_hubert_cfg`` is given); ``vocab_size`` overrides the preset vocab.
    ``add_gated_x_attn=1`` adds the gated video cross-attention and
    ``video_projection``; with ``use_av_hubert_encoder`` the AV-HuBERT video
    encoder feeds them (``video_state`` = its width), without it ``video``
    inputs are already-extracted features. ``dtype`` is the compute dtype
    and ``param_dtype`` the dtype the weights are stored in (``dtype`` when
    None: serving casts nothing; norms, BatchNorm, PReLU slopes, the
    weight-norm factors and the gates are fp32 whatever it is). Training
    passes ``param_dtype="float32"`` for fp32 weights and Adam state under
    bf16 compute, and ``dropout_rate`` for Whisper's residual dropout that
    ``model.train()`` turns on; the tower keeps its config's own dropouts
    and LayerDrop (``AVHuBERTConfig()``'s defaults for the presets).
    ``remat`` with ``remat_policy`` ("block" or "dots") checkpoints the
    activations of the Whisper encoder's blocks and of the video tower
    (its ResNet frontend and its blocks), as the JAX factory sets both
    configs' ``remat`` (:func:`~avsl_tpu_torch.models.layers.remat_block`).
    """
    dev = resolve_device(device)
    if model_name == "test":
        w_cfg = WhisperConfig.tiny_test(dtype=dtype)
        av_hubert_cfg = av_hubert_cfg or AVHuBERTConfig.tiny_test(dtype=dtype)
    else:
        w_cfg = WhisperConfig.from_name(model_name, dtype=dtype)
        av_hubert_cfg = av_hubert_cfg or AVHuBERTConfig(dtype=dtype)
    overrides: dict = {
        "add_gated_x_attn": int(add_gated_x_attn),
        "dropout_rate": float(dropout_rate),
        "param_dtype": param_dtype or dtype,
        "remat": bool(remat),
        "remat_policy": remat_policy,
    }
    if vocab_size is not None:
        overrides["n_vocab"] = int(vocab_size)
    if use_av_hubert_encoder:
        overrides["video_state"] = av_hubert_cfg.hidden_size
    w_cfg = dataclasses.replace(w_cfg, **overrides)
    video_model = None
    if use_av_hubert_encoder and add_gated_x_attn:
        av_hubert_cfg = dataclasses.replace(av_hubert_cfg, param_dtype=w_cfg.param_dtype,
                                            remat=bool(remat), remat_policy=remat_policy)
        video_model = make_av_hubert_video_encoder(av_hubert_cfg, device="meta")
    model = Whisper(w_cfg, video_model=video_model, device="meta").materialize(dev, seed=seed)
    return model.eval(), w_cfg


def build_avhubert(
    cfg: AVHuBERTConfig,
    head: str = "seq2seq",
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
    num_classes: Sequence[int] = (500,),
) -> Union[AVHuBERTForSpeech2Text, AVHuBERTForCTC, AVHuBERTForPretraining,
           AVHuBERTModel]:
    """AV-HuBERT with its ``head`` ("seq2seq": :class:`AVHuBERTForSpeech2Text`,
    "ctc": :class:`AVHuBERTForCTC`, "pretrain":
    :class:`~avsl_tpu_torch.models.pretrain.AVHuBERTForPretraining` over
    codebooks of ``num_classes``, "encoder": the bare
    :class:`AVHuBERTModel`) on ``device``, random weights from a
    ``torch.Generator`` there seeded with ``seed`` (see
    :func:`~avsl_tpu_torch.models.avhubert.init_weights`); returned in eval
    mode. Weights live in ``cfg.param_dtype`` and compute runs in
    ``cfg.dtype``."""
    classes = {"seq2seq": AVHuBERTForSpeech2Text, "ctc": AVHuBERTForCTC,
               "pretrain": functools.partial(AVHuBERTForPretraining, num_classes=num_classes),
               "encoder": AVHuBERTModel}
    if head not in classes:
        raise ValueError(f"head {head!r}: expected one of {sorted(classes)}")
    dev = resolve_device(device)
    model = classes[head](cfg, device="meta").to_empty(device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return init_weights(model, gen).eval()


def build_auto_avsr(cfg: AutoAVSRConfig, device: Union[str, torch.device] = "cuda",
                    seed: int = 0) -> AutoAVSR:
    """Auto-AVSR's audio-visual model (:class:`~avsl_tpu_torch.models.conformer.AutoAVSR`)
    on ``device`` with random weights from a ``torch.Generator`` there
    seeded with ``seed`` (fan-in-scaled normal weights, zero biases, unit
    norms, identity BatchNorm, xavier-uniform relative-position biases);
    returned in eval mode. Weights live in ``cfg.param_dtype`` and compute
    runs in ``cfg.dtype``."""
    dev = resolve_device(device)
    model = AutoAVSR(cfg, device="meta").to_empty(device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return init_weights(model, gen).eval()
