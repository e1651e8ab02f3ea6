"""Configuration, device selection and pipeline parallelism for the
PyTorch port."""

from avsl_tpu_torch.core.config import (
    AutoAVSRConfig,
    AVHuBERTConfig,
    FlamingoTrainConfig,
    WhisperConfig,
)
from avsl_tpu_torch.core.device import resolve_device
from avsl_tpu_torch.core.pipeline import (
    StackedBlocks,
    make_pp_mesh,
    pipeline_apply,
    stack_block_params,
    unstack_block_params,
)

__all__ = [
    "AVHuBERTConfig",
    "AutoAVSRConfig",
    "FlamingoTrainConfig",
    "StackedBlocks",
    "WhisperConfig",
    "make_pp_mesh",
    "pipeline_apply",
    "resolve_device",
    "stack_block_params",
    "unstack_block_params",
]
