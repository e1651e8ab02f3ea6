"""Whisper word-level timestamps from cross-attention alignment (DTW).

Port of ``avsl_tpu/decode/word_timestamps.py``: teacher-force the decoded
tokens, capture the decoder's cross-attention weights over the audio
frames, and trace the minimum-cost monotone path through the token x frame
matrix with dynamic time warping; the CTC aligner's word grouping
(``decode/ctc.py::word_alignments``) then turns token spans into words.

The capture is opt-in and local: :func:`capture_cross_attention` gives the
Whisper decoder's ``cross_attn`` modules a list, and only while it is set
does their full-sequence path run the unfused ``dot_product_attention``
and append its fp32 [B,H,Q,K] weights (masked logits at
``finfo(float32).min``, as the JAX einsum path). Every other attention
keeps the flash-attention kernel, the decoder's causal self-attention and
the gated video ``x_attn`` included: the JAX layer also records the
``x_attn`` weights but ``collect_cross_attention`` drops them (words align
to audio frames), so the port does not form them. Decode and training
forwards pay nothing.

The encoder emits one frame every 20 ms, so ``frame_rate_hz=50``. The
per-head standardisation and head mean run in float64 on the weights'
device; the median filter and the DTW run on the host, as in JAX.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from avsl_tpu_torch.decode.ctc import word_alignments


def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Minimum-cost monotone path through ``cost`` [Q, K] from (0, 0) to
    (Q-1, K-1); steps are (1,0), (0,1), (1,1). Returns (rows, cols) of the
    path, each non-decreasing. The JAX package's O(QK) host DP (ties go to
    the diagonal, then up, then left) over Python floats."""
    q, k = cost.shape
    inf = float("inf")
    prev = [0.0] + [inf] * k  # accumulated cost of row -1
    steps = []  # 0: diag, 1: up (row-1), 2: left (col-1)
    for c_row in np.asarray(cost, np.float64).tolist():
        cur = [inf] * (k + 1)
        st = [0] * k
        for j in range(k):
            best, s = prev[j], 0
            if prev[j + 1] < best:
                best, s = prev[j + 1], 1
            if cur[j] < best:
                best, s = cur[j], 2
            st[j] = s
            cur[j + 1] = best + c_row[j]
        steps.append(st)
        prev = cur
    rows, cols = [], []
    i, j = q - 1, k - 1
    while i >= 0 and j >= 0:
        rows.append(i)
        cols.append(j)
        s = steps[i][j]
        if s == 0:
            i, j = i - 1, j - 1
        elif s == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(rows[::-1]), np.asarray(cols[::-1])


def _median_filter(x: np.ndarray, width: int) -> np.ndarray:
    """Median filter along the last axis (odd width; edge-padded)."""
    if width <= 1:
        return x
    pad = width // 2
    xp = np.concatenate(
        [np.repeat(x[..., :1], pad, -1), x, np.repeat(x[..., -1:], pad, -1)], axis=-1)
    windows = np.stack([xp[..., i: i + x.shape[-1]] for i in range(width)], 0)
    return np.median(windows, axis=0)


def attention_token_spans(weights, n_frames: int, median_width: int = 7) -> List[Tuple[int, int]]:
    """Cross-attention ``weights`` [H, Q, K] (a tensor on any device, or an
    array) -> per-token frame spans (end exclusive): each head standardised
    over the first ``n_frames`` frames, the heads averaged (float64), a
    median filter, then the DTW path of the negated matrix."""
    w = torch.as_tensor(weights)[..., :n_frames].double()
    mu = w.mean(-1, keepdim=True)
    sd = w.std(-1, correction=0, keepdim=True) + 1e-9
    w = ((w - mu) / sd).mean(0).cpu().numpy()  # [Q, K]
    w = _median_filter(w, median_width)
    rows, cols = dtw_path(-w)
    spans: List[Optional[List[int]]] = [None] * w.shape[0]
    for r, c in zip(rows.tolist(), cols.tolist()):
        if spans[r] is None:
            spans[r] = [c, c + 1]
        else:
            spans[r][1] = c + 1
    return [tuple(s) for s in spans]  # the DTW path visits every row


@contextlib.contextmanager
def capture_cross_attention(model) -> Iterator[List[torch.Tensor]]:
    """Within the block, each full-sequence pass of the Whisper decoder's
    ``cross_attn`` appends its fp32 [B,H,Q,K] weights to the yielded list,
    in layer order."""
    captured: List[torch.Tensor] = []
    modules = [block.cross_attn for block in model.decoder.blocks]
    for m in modules:
        m.capture = captured
    try:
        yield captured
    finally:
        for m in modules:
            m.capture = None


def collect_cross_attention(captured: Sequence[torch.Tensor]) -> torch.Tensor:
    """Captured per-layer weights [B,H,Q,K] -> [B, L*H, Q, K] (layer-major
    heads, as the JAX function stacks them)."""
    if not captured:
        raise ValueError("no cross-attention captured: run the forward inside "
                         "capture_cross_attention")
    stacked = torch.stack(list(captured), 1)  # [B, L, H, Q, K]
    b, l, h, q, k = stacked.shape
    return stacked.reshape(b, l * h, q, k)


def align_words(model, audio_features: torch.Tensor, xv: Optional[torch.Tensor],
                tokens: np.ndarray, tokenizer, n_frames: Optional[Sequence[int]] = None,
                frame_rate_hz: float = 50.0, median_width: int = 7) -> List[List[dict]]:
    """The alignment pass over encoder outputs already computed: one
    teacher-forced decoder forward of ``tokens`` [B, L] (the prompt, the
    text and EOT) with the cross-attention captured, then per item the
    rows up to its first EOT (inclusive; padded EOT rows past it would take
    the last word's trailing frames) against its first ``n_frames[b]``
    frames (all when None). Returns ``words[b] = [{"word", "start_s",
    "end_s"}]``."""
    toks_t = torch.as_tensor(np.asarray(tokens), dtype=torch.int64, device=audio_features.device)
    with capture_cross_attention(model) as captured:
        model.decoder(toks_t, audio_features, xv=xv)
    eot = int(tokenizer.eot)
    special = tokenizer.special_token_set
    k_all = captured[0].shape[-1]
    out: List[List[dict]] = []
    for b in range(toks_t.shape[0]):
        toks = [int(t) for t in np.asarray(tokens)[b]]
        q_end = (toks.index(eot) + 1) if eot in toks else len(toks)
        nf = k_all if n_frames is None else int(n_frames[b])
        item = torch.cat([c[b, :, :q_end] for c in captured])  # [L*H, q_end, K]
        spans = attention_token_spans(item, nf, median_width)
        out.append(word_alignments(toks[:q_end], spans, tokenizer,
                                   frame_rate_hz=frame_rate_hz, special_ids=special))
    return out


@torch.inference_mode()
def whisper_word_timestamps(model, mel, tokens, tokenizer,
                            n_frames: Optional[Sequence[int]] = None, video=None,
                            frame_rate_hz: float = 50.0, median_width: int = 7) -> List[List[dict]]:
    """Teacher-forced alignment pass -> per-item word timestamps, in eval
    mode (the caller's mode is restored). ``mel`` [B, n_mels, T], ``tokens``
    [B, L] the full decoded sequence (SOT prompt, text, EOT), ``video`` the
    lip frames of a Whisper-Flamingo model; ``n_frames`` the true encoder
    frames of each item (all when None)."""
    was_training = model.training
    model.eval()
    try:
        device = model.device
        v = None if video is None else torch.as_tensor(video).to(device)
        feats, xv = model.encode(torch.as_tensor(mel).to(device), v)
        return align_words(model, feats, xv, tokens, tokenizer, n_frames, frame_rate_hz,
                           median_width)
    finally:
        model.train(was_training)
