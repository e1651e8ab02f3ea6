"""Whisper(-Flamingo) model, AV-HuBERT (video tower, seq2seq and CTC
heads, span masks, the MoE FFN, masked-cluster pretraining), Auto-AVSR's
audio-visual Conformer, layers, factory and weight carrier of the PyTorch
port."""

from avsl_tpu_torch.models.avhubert import (
    AVHuBERTForCTC,
    AVHuBERTForSpeech2Text,
    AVHuBERTModel,
    span_mask,
)
from avsl_tpu_torch.models.conformer import AutoAVSR
from avsl_tpu_torch.models.convert import (
    avhubert_state_dict_from_flax,
    pretrain_state_dict_from_flax,
    state_dict_from_flax,
    whisper_state_dict_from_flax,
)
from avsl_tpu_torch.models.factory import (
    build_auto_avsr,
    build_avhubert,
    build_whisper_flamingo,
    make_av_hubert_video_encoder,
)
from avsl_tpu_torch.models.moe import MoEFFN, moe_aux_loss
from avsl_tpu_torch.models.pretrain import (
    AVHuBERTForPretraining,
    extract_layer_features,
    pretrain_loss,
)
from avsl_tpu_torch.models.quant import QTensor, quantization_report, quantize_model
from avsl_tpu_torch.models.resnet3d import ResNet3DFrontend
from avsl_tpu_torch.models.whisper import Whisper, WhisperEncoder, WhisperTextDecoder

__all__ = [
    "QTensor",
    "AVHuBERTForCTC",
    "AVHuBERTForPretraining",
    "AVHuBERTForSpeech2Text",
    "AVHuBERTModel",
    "AutoAVSR",
    "MoEFFN",
    "ResNet3DFrontend",
    "Whisper",
    "WhisperEncoder",
    "WhisperTextDecoder",
    "avhubert_state_dict_from_flax",
    "build_auto_avsr",
    "build_avhubert",
    "build_whisper_flamingo",
    "extract_layer_features",
    "make_av_hubert_video_encoder",
    "moe_aux_loss",
    "pretrain_loss",
    "pretrain_state_dict_from_flax",
    "quantization_report",
    "quantize_model",
    "span_mask",
    "state_dict_from_flax",
    "whisper_state_dict_from_flax",
]
