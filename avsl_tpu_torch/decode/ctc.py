"""CTC decoding for the AV-HuBERT CTC head (host-side numpy).

A copy of ``avsl_tpu/decode/ctc.py``: best-path (greedy) decoding --
argmax per frame, collapse repeats, drop blanks (the pad id) -- with a
scored variant that also returns the mean per-frame log-probability of
the path, prefix beam search, decoding to text, Viterbi forced alignment
of a known transcript, and word timestamps from the aligned spans.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def ctc_best_path(
    logits: np.ndarray,  # [B, T, V] (or jax array)
    blank_id: int = 0,
    logit_pad: Optional[np.ndarray] = None,  # [B, T] 1.0 = padded frame
) -> List[List[int]]:
    """Best-path decode: per-frame argmax -> collapse repeats -> drop
    blanks. Padded frames (``logit_pad``) are excluded entirely."""
    logits = np.asarray(logits)
    preds = logits.argmax(axis=-1)  # [B, T]
    out: List[List[int]] = []
    for b in range(preds.shape[0]):
        seq = preds[b]
        if logit_pad is not None:
            seq = seq[np.asarray(logit_pad[b]) < 0.5]
        prev = -1
        toks: List[int] = []
        for t in seq.tolist():
            if t != prev and t != blank_id:
                toks.append(int(t))
            prev = t
        out.append(toks)
    return out


def ctc_best_path_scores(
    logits: np.ndarray,
    blank_id: int = 0,
    logit_pad: Optional[np.ndarray] = None,
) -> Tuple[List[List[int]], np.ndarray]:
    """Best-path decode plus the mean per-frame log-probability of the
    chosen path (a cheap confidence signal for filtering)."""
    logits = np.asarray(logits, np.float32)
    logp = logits - _logsumexp(logits, axis=-1, keepdims=True)
    preds = logp.argmax(axis=-1)
    scores = np.take_along_axis(logp, preds[..., None], axis=-1)[..., 0]  # [B, T]
    seqs = ctc_best_path(logits, blank_id, logit_pad)
    if logit_pad is not None:
        valid = np.asarray(logit_pad) < 0.5
        mean = (scores * valid).sum(-1) / np.maximum(valid.sum(-1), 1)
    else:
        mean = scores.mean(-1)
    return seqs, mean


def _logsumexp(x, axis=-1, keepdims=False):
    m = np.max(x, axis=axis, keepdims=True)
    out = m + np.log(np.sum(np.exp(x - m), axis=axis, keepdims=True))
    return out if keepdims else np.squeeze(out, axis)


def ctc_prefix_beam_search(
    logits: np.ndarray,  # [T, V] single sequence
    beam_size: int = 8,
    blank_id: int = 0,
    logit_pad: Optional[np.ndarray] = None,  # [T] 1.0 = padded frame
) -> Tuple[List[int], float]:
    """Prefix beam search over CTC output distributions (Hannun et al.,
    2014): sums path probabilities over all alignments of each prefix
    (tracked separately for blank- and non-blank-ending paths), which
    best-path decoding approximates with the single argmax alignment.
    Returns (tokens, log-probability of the best prefix)."""
    logits = np.asarray(logits, np.float32)
    logp = logits - _logsumexp(logits, axis=-1, keepdims=True)
    t_len, vocab = logp.shape

    NEG = -1e30

    def logadd(a, b):
        if a <= NEG:
            return b
        if b <= NEG:
            return a
        m = max(a, b)
        return m + np.log(np.exp(a - m) + np.exp(b - m))

    # prefix -> (log P(prefix, ends in blank), log P(prefix, ends non-blank))
    beams = {(): (0.0, NEG)}
    for t in range(t_len):
        if logit_pad is not None and logit_pad[t] >= 0.5:
            continue
        frame = logp[t]
        # only the top candidates per frame matter for realistic beams —
        # but blank must ALWAYS be considered: dropping it starves
        # blank-separated prefixes of all their probability mass
        k = min(beam_size * 2, vocab)
        cand = np.argpartition(frame, -k)[-k:]
        if blank_id not in cand:
            cand = np.append(cand, blank_id)
        nxt: dict = {}

        def acc(prefix, pb, pnb):
            opb, opnb = nxt.get(prefix, (NEG, NEG))
            nxt[prefix] = (logadd(opb, pb), logadd(opnb, pnb))

        for prefix, (pb, pnb) in beams.items():
            total = logadd(pb, pnb)
            for v in cand:
                v = int(v)
                lv = float(frame[v])
                if v == blank_id:
                    acc(prefix, total + lv, NEG)
                elif prefix and v == prefix[-1]:
                    # repeat: extends the blank-ending paths; non-blank-
                    # ending paths merge into the SAME prefix
                    acc(prefix + (v,), NEG, pb + lv)
                    acc(prefix, NEG, pnb + lv)
                else:
                    acc(prefix + (v,), NEG, total + lv)
        beams = dict(
            sorted(nxt.items(), key=lambda kv: -logadd(*kv[1]))[:beam_size]
        )
    best, (pb, pnb) = max(beams.items(), key=lambda kv: logadd(*kv[1]))
    return list(best), logadd(pb, pnb)


def ctc_prefix_beam_search_batch(
    logits: np.ndarray,  # [B, T, V]
    beam_size: int = 8,
    blank_id: int = 0,
    logit_pad: Optional[np.ndarray] = None,  # [B, T]
) -> Tuple[List[List[int]], List[float]]:
    """Batched host-side prefix beam search."""
    seqs, scores = [], []
    for b in range(np.asarray(logits).shape[0]):
        s, sc = ctc_prefix_beam_search(
            logits[b], beam_size, blank_id,
            None if logit_pad is None else logit_pad[b],
        )
        seqs.append(s)
        scores.append(sc)
    return seqs, scores


def ctc_decode_to_text(
    logits: np.ndarray,
    tokenizer,
    blank_id: int = 0,
    logit_pad: Optional[np.ndarray] = None,
) -> List[str]:
    """Decode straight to text through a tokenizer (special ids dropped)."""
    special = getattr(tokenizer, "special_token_set", set())
    return [
        tokenizer.decode([t for t in seq if t not in special])
        for seq in ctc_best_path(logits, blank_id, logit_pad)
    ]


def ctc_forced_align(
    log_probs: np.ndarray,  # [T, V] log-softmax frame posteriors
    targets: Sequence[int],
    blank_id: int = 0,
) -> Tuple[List[Tuple[int, int]], float]:
    """Viterbi forced alignment of a known transcript to CTC frames.

    The reference has no alignment capability at all; this recovers
    per-token time spans from the AV-HuBERT CTC head — re-segmenting
    long AMI recordings, word-level subtitle timing, and locating
    `<laugh>` events, all without an external aligner.

    Standard CTC topology: the extended state sequence interleaves
    blanks (`b t1 b t2 b ... b`); transitions are stay / advance-1 /
    advance-2 (the skip allowed only onto a non-blank that differs from
    the token two states back). DP is vectorized over states (host
    numpy, O(T·S) like the prefix beam).

    Returns (spans, score): ``spans[i] = (start_frame, end_frame)`` —
    end exclusive — for ``targets[i]``, and the best path's total log
    probability (brute-force checked in the JAX package's decode tests).
    """
    lp = np.asarray(log_probs, np.float64)
    T = lp.shape[0]
    tgt = [int(t) for t in targets]
    L = len(tgt)
    if L == 0:
        return [], float(lp[:, blank_id].sum())
    ext = np.empty(2 * L + 1, np.int64)
    ext[0::2] = blank_id
    ext[1::2] = tgt
    S = ext.size
    # CTC feasibility: every token needs a frame PLUS a mandatory blank
    # between each adjacent repeated pair (the skip transition is
    # forbidden there) — `T >= L` alone under-counts and the DP would
    # backtrace through an all -1e30 table into nonsense spans
    need = L + sum(1 for a, b in zip(tgt, tgt[1:]) if a == b)
    if T < need:
        raise ValueError(
            f"{T} frames cannot emit {L} target tokens "
            f"({need} emission slots incl. repeat-separating blanks)"
        )

    NEG = -1e30
    # skip allowed into state s when ext[s] is a label differing from ext[s-2]
    can_skip = np.zeros(S, bool)
    can_skip[2:] = (ext[2:] != blank_id) & (ext[2:] != ext[:-2])

    dp = np.full(S, NEG)
    dp[0] = lp[0, ext[0]]
    if S > 1:
        dp[1] = lp[0, ext[1]]
    bp = np.zeros((T, S), np.int8)
    for t in range(1, T):
        stay = dp
        adv1 = np.concatenate(([NEG], dp[:-1]))
        adv2 = np.where(can_skip, np.concatenate(([NEG, NEG], dp[:-2])), NEG)
        stacked = np.stack([stay, adv1, adv2])  # [3, S]
        k = np.argmax(stacked, axis=0)
        bp[t] = k
        dp = stacked[k, np.arange(S)] + lp[t, ext]

    s = S - 1 if (S == 1 or dp[S - 1] >= dp[S - 2]) else S - 2
    score = float(dp[s])
    states = np.empty(T, np.int64)
    for t in range(T - 1, -1, -1):
        states[t] = s
        # a Python int: int8 arithmetic would overflow past state 127 (64+
        # tokens), where the JAX package's copy raises under numpy 2
        s -= int(bp[t, s])

    spans: List[Optional[List[int]]] = [None] * L
    for t, st in enumerate(states.tolist()):
        if st % 2 == 1:
            i = st // 2
            if spans[i] is None:
                spans[i] = [t, t + 1]
            else:
                spans[i][1] = t + 1
    assert all(sp is not None for sp in spans)
    return [tuple(sp) for sp in spans], score


def word_alignments(
    tokens: Sequence[int],
    spans: Sequence[Tuple[int, int]],
    tokenizer,
    frame_rate_hz: float = 25.0,
    special_ids: Optional[set] = None,
) -> List[dict]:
    """Token spans -> word-level timestamps.

    Byte-level BPE marks word starts with a leading space on the
    decoded piece; consecutive pieces without one extend the current
    word. Returns ``[{"word", "start_s", "end_s"}]`` in order
    (``frame_rate_hz``: CTC frame rate — 25 Hz for the video-locked
    AV-HuBERT encoder features)."""
    special = special_ids if special_ids is not None else getattr(
        tokenizer, "special_token_set", set()
    )
    words: List[dict] = []
    for tok, (f0, f1) in zip(tokens, spans):
        if tok in special:
            continue
        piece = tokenizer.decode([int(tok)])
        if not piece:
            continue
        new_word = piece.startswith(" ") or not words
        if new_word:
            words.append({
                "word": piece.strip(),
                "start_s": round(f0 / frame_rate_hz, 3),
                "end_s": round(f1 / frame_rate_hz, 3),
            })
        else:
            words[-1]["word"] += piece
            words[-1]["end_s"] = round(f1 / frame_rate_hz, 3)
    return [w for w in words if w["word"]]
