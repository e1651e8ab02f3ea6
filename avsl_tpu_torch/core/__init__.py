"""Configuration and device selection for the PyTorch port."""

from avsl_tpu_torch.core.config import AVHuBERTConfig, FlamingoTrainConfig, WhisperConfig
from avsl_tpu_torch.core.device import resolve_device

__all__ = ["AVHuBERTConfig", "FlamingoTrainConfig", "WhisperConfig", "resolve_device"]
