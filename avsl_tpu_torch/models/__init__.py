"""Whisper(-Flamingo) model, AV-HuBERT (video tower, seq2seq and CTC
heads), layers, factory and weight carrier of the PyTorch port."""

from avsl_tpu_torch.models.avhubert import AVHuBERTForCTC, AVHuBERTForSpeech2Text, AVHuBERTModel
from avsl_tpu_torch.models.convert import (
    avhubert_state_dict_from_flax,
    state_dict_from_flax,
    whisper_state_dict_from_flax,
)
from avsl_tpu_torch.models.factory import (
    build_avhubert,
    build_whisper_flamingo,
    make_av_hubert_video_encoder,
)
from avsl_tpu_torch.models.quant import QTensor, quantization_report, quantize_model
from avsl_tpu_torch.models.resnet3d import ResNet3DFrontend
from avsl_tpu_torch.models.whisper import Whisper, WhisperEncoder, WhisperTextDecoder

__all__ = [
    "QTensor",
    "AVHuBERTForCTC",
    "AVHuBERTForSpeech2Text",
    "AVHuBERTModel",
    "ResNet3DFrontend",
    "Whisper",
    "WhisperEncoder",
    "WhisperTextDecoder",
    "avhubert_state_dict_from_flax",
    "build_avhubert",
    "build_whisper_flamingo",
    "make_av_hubert_video_encoder",
    "quantization_report",
    "quantize_model",
    "state_dict_from_flax",
    "whisper_state_dict_from_flax",
]
