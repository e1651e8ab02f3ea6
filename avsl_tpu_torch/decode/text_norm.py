"""Text normalization and WER/CER metrics (self-contained, jiwer-equivalent).

A copy of ``avsl_tpu/decode/text_norm.py`` (the port imports nothing of
the JAX package).

The reference defines its official normalization through a jiwer Compose
(avsl/whisper_flamingo_ft_ami.py:237-248, 598-609): expand common English
contractions, substitute {'cause/cuz -> because, c'mon -> come on}, remove
punctuation, collapse whitespace, strip, lowercase. Implemented here from
scratch so the framework carries no jiwer dependency; WER/CER aggregate
edit distance over the corpus (sum of edits / sum of reference tokens),
matching the external ``wer_cer`` helper's contract.
"""

from __future__ import annotations

import re
import string
from typing import Iterable, List, Sequence, Tuple

# Ordered: specific forms first, then generic suffix rules (jiwer's
# ExpandCommonEnglishContractions structure).
_CONTRACTIONS: List[Tuple[str, str]] = [
    (r"won't", "will not"),
    (r"can't", "can not"),
    (r"let's", "let us"),
    (r"ain't", "am not"),
    (r"y'all", "you all"),
    (r"n't\b", " not"),
    (r"'re\b", " are"),
    (r"'s\b", " is"),
    (r"'d\b", " would"),
    (r"'ll\b", " will"),
    (r"'ve\b", " have"),
    (r"'m\b", " am"),
]

_WORD_SUBS = {
    "'cause": "because",
    "cuz": "because",
    "c'mon": "come on",
}

_PUNCT_TABLE = str.maketrans("", "", string.punctuation)


def expand_contractions(text: str) -> str:
    for pat, rep in _CONTRACTIONS:
        text = re.sub(pat, rep, text, flags=re.IGNORECASE)
    return text


def substitute_words(text: str, subs=None) -> str:
    subs = _WORD_SUBS if subs is None else subs
    words = text.split()
    return " ".join(subs.get(w.lower(), w) for w in words)


def normalize_text(text: str) -> str:
    """Full normalization pipeline (expand -> substitute -> strip punct ->
    collapse spaces -> strip -> lowercase); underscores removed first as in
    the reference dataset path (whisper_flamingo_ft_ami.py:240)."""
    text = text.replace("_", "")
    text = substitute_words(text)  # before expansion so c'mon survives intact
    text = expand_contractions(text)
    text = text.translate(_PUNCT_TABLE)
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance between two token sequences."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        for j in range(1, m + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[m]


def wer_cer(
    hypo: Iterable[str], ref: Iterable[str], already_normalized: bool = True
) -> Tuple[float, float]:
    """Corpus-level WER and CER: total edits / total reference length."""
    word_edits = word_total = char_edits = char_total = 0
    for h, r in zip(hypo, ref):
        if not already_normalized:
            h, r = normalize_text(h), normalize_text(r)
        rw, hw = r.split(), h.split()
        word_edits += edit_distance(rw, hw)
        word_total += len(rw)
        rc, hc = list(r), list(h)
        char_edits += edit_distance(rc, hc)
        char_total += len(rc)
    wer = word_edits / word_total if word_total else 0.0
    cer = char_edits / char_total if char_total else 0.0
    return wer, cer


def compression_ratio(text: str) -> float:
    """len(utf-8) / len(zlib-compressed): the Whisper-serving repetition
    detector — looping/hallucinated output compresses far better than
    speech, so a high ratio flags a bad decode. ~1.0-2.0 for normal
    text; > ~2.4 is the customary retry trigger."""
    import zlib

    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))
