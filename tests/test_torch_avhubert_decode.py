"""The port's CTC decoding (``avsl_tpu_torch.decode.ctc``, a copy of the
JAX package's numpy module) against ``avsl_tpu.decode.ctc`` on the same
seeded logits: best path with scores, prefix beam search (one row and a
batch), text through a tokenizer, forced alignment and word timings, with
padded frames. Host numpy on both sides: the results are identical.
"""

import numpy as np
import pytest

from avsl_tpu.decode import ctc as jax_ctc
from avsl_tpu_torch import decode
from avsl_tpu_torch.data.tokenizer import ByteTokenizer
from avsl_tpu_torch.decode import ctc

BLANK = 1


def _logits(seed, b=3, t=14, v=12):
    rng = np.random.default_rng(seed)
    logits = 2.0 * rng.normal(size=(b, t, v)).astype(np.float32)
    logits[:, ::3, BLANK] += 3.0  # blanks between runs
    pad = np.zeros((b, t), np.float32)
    pad[1:, t - 5:] = 1.0
    pad[2:, 4:] = 1.0
    return logits, pad


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_ctc_greedy_and_beam_match_jax(seed):
    logits, pad = _logits(seed)
    for padding in (None, pad):
        assert ctc.ctc_best_path(logits, BLANK, padding) == \
            jax_ctc.ctc_best_path(logits, BLANK, padding)
        seqs, scores = ctc.ctc_best_path_scores(logits, BLANK, padding)
        want_seqs, want_scores = jax_ctc.ctc_best_path_scores(logits, BLANK, padding)
        assert seqs == want_seqs
        np.testing.assert_array_equal(scores, want_scores)
        got = ctc.ctc_prefix_beam_search_batch(logits, 4, BLANK, padding)
        assert got == jax_ctc.ctc_prefix_beam_search_batch(logits, 4, BLANK, padding)
    assert ctc.ctc_prefix_beam_search(logits[1], 3, BLANK, pad[1]) == \
        jax_ctc.ctc_prefix_beam_search(logits[1], 3, BLANK, pad[1])
    tok = ByteTokenizer()
    text_logits = np.zeros((1, 6, 260), np.float32)
    text_logits[0, np.arange(6), [104, 104, BLANK, 105, BLANK, tok.eot]] = 5.0
    assert ctc.ctc_decode_to_text(text_logits, tok, BLANK) == \
        jax_ctc.ctc_decode_to_text(text_logits, tok, BLANK) == ["hi"]


@pytest.mark.parametrize("targets", [[3, 5, 5, 7], [4], []])
def test_torch_ctc_forced_align_and_words_match_jax(targets):
    logits, _ = _logits(7, b=1, t=12)
    log_probs = logits[0] - np.log(np.exp(logits[0]).sum(-1, keepdims=True))
    spans, score = ctc.ctc_forced_align(log_probs, targets, BLANK)
    want_spans, want_score = jax_ctc.ctc_forced_align(log_probs, targets, BLANK)
    assert spans == want_spans and score == want_score
    tok = ByteTokenizer()
    words = [ord(c) for c in " go home"][: 2 * len(targets)]
    spans_w = [(2 * i, 2 * i + 1) for i in range(len(words))]
    assert ctc.word_alignments(words, spans_w, tok) == \
        jax_ctc.word_alignments(words, spans_w, tok)
    with pytest.raises(ValueError, match="cannot emit"):
        ctc.ctc_forced_align(log_probs[:2], [3, 3, 4], BLANK)


def test_torch_ctc_is_exported():
    assert decode.ctc_best_path_scores is ctc.ctc_best_path_scores
    assert decode.ctc_prefix_beam_search_batch is ctc.ctc_prefix_beam_search_batch
