"""Device kernels of the port: the log-mel front end (plain PyTorch ops)
and the flash-attention forward (a hand-written CUDA kernel)."""

from avsl_tpu_torch.kernels.attention import fused_attention, reference_attention
from avsl_tpu_torch.kernels.logmel import log_mel_spectrogram, pad_or_trim
from avsl_tpu_torch.kernels.mel import mel_filterbank_slaney

__all__ = [
    "fused_attention",
    "log_mel_spectrogram",
    "mel_filterbank_slaney",
    "pad_or_trim",
    "reference_attention",
]
