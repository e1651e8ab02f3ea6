"""Decoding and text metrics of the port."""

from avsl_tpu_torch.decode.beam import beam_search
from avsl_tpu_torch.decode.biasing import (
    BiasingTrie,
    bias_adjust,
    bias_advance,
    build_biasing_trie,
    encode_phrases,
)
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
    sampled_decode_scored,
    teacher_forced_predictions,
)
from avsl_tpu_torch.decode.language import detect_language, detect_language_logits
from avsl_tpu_torch.decode.speculative import SpecDecodeResult, speculative_greedy_decode
from avsl_tpu_torch.decode.text_norm import compression_ratio, normalize_text, wer_cer
from avsl_tpu_torch.decode.word_timestamps import (
    attention_token_spans,
    capture_cross_attention,
    collect_cross_attention,
    dtw_path,
    whisper_word_timestamps,
)

__all__ = [
    "BiasingTrie",
    "SpecDecodeResult",
    "attention_token_spans",
    "beam_search",
    "bias_adjust",
    "bias_advance",
    "build_biasing_trie",
    "capture_cross_attention",
    "collect_cross_attention",
    "compression_ratio",
    "ctc_best_path",
    "ctc_best_path_scores",
    "ctc_decode_to_text",
    "ctc_forced_align",
    "ctc_prefix_beam_search",
    "ctc_prefix_beam_search_batch",
    "detect_language",
    "detect_language_logits",
    "dtw_path",
    "encode_phrases",
    "greedy_decode",
    "greedy_decode_scored",
    "mask_after_eot",
    "normalize_text",
    "sampled_decode_scored",
    "speculative_greedy_decode",
    "teacher_forced_predictions",
    "wer_cer",
    "whisper_word_timestamps",
    "word_alignments",
]
