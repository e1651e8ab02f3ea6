"""Device kernels of the port: the log-mel front end and SpecAugment
(plain PyTorch ops) and the flash-attention forward and backward
(hand-written CUDA kernels)."""

from avsl_tpu_torch.kernels.attention import (
    fused_attention,
    fused_attention_bwd,
    reference_attention,
    reference_attention_bwd,
)
from avsl_tpu_torch.kernels.logmel import log_mel_spectrogram, pad_or_trim
from avsl_tpu_torch.kernels.mel import mel_filterbank_slaney
from avsl_tpu_torch.kernels.specaugment import spec_augment_batch

__all__ = [
    "fused_attention",
    "fused_attention_bwd",
    "log_mel_spectrogram",
    "mel_filterbank_slaney",
    "pad_or_trim",
    "reference_attention",
    "reference_attention_bwd",
    "spec_augment_batch",
]
