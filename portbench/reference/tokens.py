"""The decoder inputs and labels of a transcript, as the port's offline
byte tokenizer and ``WhisperVideoCollator`` lay them out for Whisper:
ids 0-255 are the UTF-8 bytes, then ``<|endoftext|>`` (256),
``<|startoftranscript|>`` (257), the 99 Whisper language tokens in
Whisper's order (English 258), ``<|translate|>``, ``<|transcribe|>`` and
``<|notimestamps|>`` (357-359). The decoder reads the start sequence and
the bytes of " " + text; the labels are that shifted left with
``<|endoftext|>`` last; both are cut and padded to ``length`` (labels with
-100, inputs with ``<|endoftext|>``). Transcripts are taken as already
normalised (the traffic's words are)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

EOT, SOT, EN = 256, 257, 258
TRANSCRIBE, NO_TIMESTAMPS = 358, 359
PROMPT = [SOT, EN, TRANSCRIBE, NO_TIMESTAMPS]


def example(text: str) -> Tuple[List[int], List[int]]:
    dec = PROMPT + list((" " + text.strip()).encode("utf-8"))
    return dec, dec[1:] + [EOT]


def batch(texts: Sequence[str], length: int) -> Tuple[np.ndarray, np.ndarray]:
    """(decoder inputs, labels) [B, length] int64."""
    dec = np.full((len(texts), length), EOT, np.int64)
    lab = np.full((len(texts), length), -100, np.int64)
    for i, t in enumerate(texts):
        d, l = example(t)
        dec[i, : min(len(d), length)] = d[:length]
        lab[i, : min(len(l), length)] = l[:length]
    return dec, lab
