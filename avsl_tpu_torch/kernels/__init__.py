"""Device kernels of the port: the log-mel front end, SpecAugment, the
polyphase resampler and the lip-ROI frontend (warp, NCC tracking, the
staged frontend; plain PyTorch ops) and the flash-attention forward and
backward (hand-written CUDA kernels)."""

from avsl_tpu_torch.kernels.attention import (
    fused_attention,
    fused_attention_bwd,
    reference_attention,
    reference_attention_bwd,
)
from avsl_tpu_torch.kernels.lip_pipeline import make_lip_frontend, make_staged_lip_frontend
from avsl_tpu_torch.kernels.logmel import log_mel_spectrogram, pad_or_trim
from avsl_tpu_torch.kernels.mel import mel_filterbank_slaney
from avsl_tpu_torch.kernels.resample import resample_poly
from avsl_tpu_torch.kernels.specaugment import spec_augment_batch
from avsl_tpu_torch.kernels.track import (
    ncc_track_batch,
    ncc_track_batch_anchored,
    ncc_track_clip,
    ncc_track_clip_anchored,
)
from avsl_tpu_torch.kernels.warp import (
    sample_separable,
    separable_crop_coords,
    separable_crop_coords_np,
    umeyama,
    warp_and_crop_clip,
    warp_and_crop_clip_separable,
)

__all__ = [
    "fused_attention",
    "fused_attention_bwd",
    "log_mel_spectrogram",
    "make_lip_frontend",
    "make_staged_lip_frontend",
    "mel_filterbank_slaney",
    "ncc_track_batch",
    "ncc_track_batch_anchored",
    "ncc_track_clip",
    "ncc_track_clip_anchored",
    "pad_or_trim",
    "reference_attention",
    "reference_attention_bwd",
    "resample_poly",
    "sample_separable",
    "separable_crop_coords",
    "separable_crop_coords_np",
    "spec_augment_batch",
    "umeyama",
    "warp_and_crop_clip",
    "warp_and_crop_clip_separable",
]
