"""Whisper(-Flamingo) model, AV-HuBERT video tower, layers, factory and
weight carrier of the PyTorch port."""

from avsl_tpu_torch.models.avhubert import AVHuBERTModel
from avsl_tpu_torch.models.convert import state_dict_from_flax, whisper_state_dict_from_flax
from avsl_tpu_torch.models.factory import build_whisper_flamingo, make_av_hubert_video_encoder
from avsl_tpu_torch.models.resnet3d import ResNet3DFrontend
from avsl_tpu_torch.models.whisper import Whisper, WhisperEncoder, WhisperTextDecoder

__all__ = [
    "AVHuBERTModel",
    "ResNet3DFrontend",
    "Whisper",
    "WhisperEncoder",
    "WhisperTextDecoder",
    "build_whisper_flamingo",
    "make_av_hubert_video_encoder",
    "state_dict_from_flax",
    "whisper_state_dict_from_flax",
]
