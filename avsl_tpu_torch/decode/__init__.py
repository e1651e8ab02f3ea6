"""Decoding and text metrics of the port."""

from avsl_tpu_torch.decode.ctc import (
    ctc_best_path,
    ctc_best_path_scores,
    ctc_decode_to_text,
    ctc_forced_align,
    ctc_prefix_beam_search,
    ctc_prefix_beam_search_batch,
    word_alignments,
)
from avsl_tpu_torch.decode.greedy import (
    greedy_decode,
    greedy_decode_scored,
    mask_after_eot,
    teacher_forced_predictions,
)
from avsl_tpu_torch.decode.text_norm import compression_ratio, normalize_text, wer_cer

__all__ = [
    "compression_ratio",
    "ctc_best_path",
    "ctc_best_path_scores",
    "ctc_decode_to_text",
    "ctc_forced_align",
    "ctc_prefix_beam_search",
    "ctc_prefix_beam_search_batch",
    "greedy_decode",
    "greedy_decode_scored",
    "mask_after_eot",
    "normalize_text",
    "teacher_forced_predictions",
    "wer_cer",
    "word_alignments",
]
