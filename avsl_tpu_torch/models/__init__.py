"""Whisper model, layers, factory and weight carrier of the PyTorch port."""

from avsl_tpu_torch.models.convert import whisper_state_dict_from_flax
from avsl_tpu_torch.models.factory import build_whisper_flamingo
from avsl_tpu_torch.models.whisper import Whisper, WhisperEncoder, WhisperTextDecoder

__all__ = [
    "Whisper",
    "WhisperEncoder",
    "WhisperTextDecoder",
    "build_whisper_flamingo",
    "whisper_state_dict_from_flax",
]
