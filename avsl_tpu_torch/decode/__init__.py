"""Decoding and text metrics of the port."""

from avsl_tpu_torch.decode.greedy import (
    greedy_decode,
    greedy_decode_scored,
    mask_after_eot,
    teacher_forced_predictions,
)
from avsl_tpu_torch.decode.text_norm import compression_ratio, normalize_text, wer_cer

__all__ = [
    "compression_ratio",
    "greedy_decode",
    "greedy_decode_scored",
    "mask_after_eot",
    "normalize_text",
    "teacher_forced_predictions",
    "wer_cer",
]
