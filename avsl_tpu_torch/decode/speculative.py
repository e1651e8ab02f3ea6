"""Speculative greedy decoding: a small draft model proposes k tokens, the
target model verifies all of them in one forward pass.

Port of ``avsl_tpu/decode/speculative.py`` (``SpecDecodeResult``,
``broadcast_cache_index``, ``set_cache_index``, ``_cache_max_len``,
``speculative_greedy_decode``). The decode is token-exact against plain
greedy decoding of the target: the verify pass teacher-forces the draft's
proposals, the accepted prefix is what greedy would have picked, and the
first mismatch takes the target's own argmax; a round commits 1 to k+1
tokens for one target forward and k draft forwards.

The JAX ``lax.while_loop`` becomes a Python loop over rounds with one
host read a round (whether every sequence has finished). Everything else
stays on the device, as tensors, in the order of the JAX loop body:
acceptance, the commits with the EOT cut and the token budget, the
scores, the last two committed tokens, and the rollback, which is only a
rewrite of the per-sequence [B] cache indices (``models/layers.py``'s
vector-index self cache: rejected rows are never attended and are
overwritten by the next round). Cache invariant between rounds (L = a
sequence's committed length, prompt included): the target has processed
``y[0:L-1]`` (index L-1), the draft ``y[0:L-2]`` (index L-2); the draft's
first step feeds the last two committed tokens. Works with any
``step_fn(tokens [B, Q], cache) -> (logits, cache)`` over the port's
caches (Whisper's and AV-HuBERT's), the int8 cross cache included.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

StepFn = Callable


class SpecDecodeResult(NamedTuple):
    tokens: torch.Tensor       # [B, max_new_tokens], EOT-padded
    avg_logprob: torch.Tensor  # [B] fp32, mean target log-prob of committed tokens
    accept_rate: torch.Tensor  # [] fp32, committed draft tokens / drafted tokens
    rounds: int                # verify passes run


def _rewrite_cache_indices(cache: Any, fn: Callable) -> Any:
    """Apply ``fn(index, entry)`` to every incremental self-attention
    ``index`` (the dicts holding k/v/index), leaving cross and "xv"
    entries as they are."""
    if isinstance(cache, dict):
        if "index" in cache and "k" in cache:
            return {**cache, "index": fn(cache["index"], cache)}
        return {k: _rewrite_cache_indices(v, fn) for k, v in cache.items()}
    if isinstance(cache, list):
        return [_rewrite_cache_indices(v, fn) for v in cache]
    return cache


def broadcast_cache_index(cache: Any, batch: int) -> Any:
    """Turn scalar cache indices into per-sequence [batch] tensors."""
    def fn(index, entry):
        if isinstance(index, torch.Tensor) and index.ndim == 1:
            return index
        return torch.full((batch,), int(index), dtype=torch.int64, device=entry["k"].device)

    return _rewrite_cache_indices(cache, fn)


def set_cache_index(cache: Any, index: torch.Tensor) -> Any:
    return _rewrite_cache_indices(cache, lambda _, __: index)


def _cache_max_len(cache: Any) -> int:
    """The length of the first self-attention buffer ([B,H,T,D]); 0 if none."""
    if isinstance(cache, dict):
        if "index" in cache and "k" in cache:
            return cache["k"].shape[2]
        for v in cache.values():
            n = _cache_max_len(v)
            if n:
                return n
    if isinstance(cache, list):
        for v in cache:
            n = _cache_max_len(v)
            if n:
                return n
    return 0


def speculative_greedy_decode(
    target_step: StepFn,
    draft_step: StepFn,
    target_cache,
    draft_cache,
    init_tokens: torch.Tensor,
    max_new_tokens: int,
    eot_id: int,
    k: int = 4,
) -> SpecDecodeResult:
    """Greedy decode of the target model, accelerated by a draft model.

    ``init_tokens`` [B, P] is the prompt (P >= 2, true of every Whisper
    SOT sequence). Both caches must be fresh (index 0) with ``max_len >=
    P + max_new_tokens + k``. Returns the tokens ``greedy_decode`` of the
    target gives and an ``avg_logprob`` over the same committed tokens as
    ``greedy_decode_scored``'s, the share of drafted tokens committed and
    the number of verify rounds, as the JAX function computes them."""
    b, p = init_tokens.shape
    if p < 2:
        raise ValueError("speculative decode needs a prompt of >= 2 tokens")
    if k < 1:
        raise ValueError("k must be >= 1")
    need = p + max_new_tokens + k
    for name, c in (("target", target_cache), ("draft", draft_cache)):
        max_len = _cache_max_len(c)
        if max_len and max_len < need:
            raise ValueError(f"{name} cache max_len {max_len} < prompt + max_new + k = {need}")

    device = init_tokens.device
    target_cache = broadcast_cache_index(target_cache, b)
    draft_cache = broadcast_cache_index(draft_cache, b)

    # warm the caches to the invariant: the target has processed y[0:P-1],
    # the draft y[0:P-2]
    _, target_cache = target_step(init_tokens[:, : p - 1], target_cache)
    if p > 2:
        _, draft_cache = draft_step(init_tokens[:, : p - 2], draft_cache)

    out_w = max_new_tokens + k + 1
    j_ids = torch.arange(k + 1, device=device)[None, :]  # [1, k+1]
    # one column past out_w takes the writes JAX's scatter drops
    out = torch.full((b, out_w + 1), eot_id, dtype=torch.int64, device=device)
    length = torch.full((b,), p, dtype=torch.int64, device=device)
    last2 = init_tokens[:, p - 2:].to(torch.int64)
    finished = torch.zeros((b,), dtype=torch.bool, device=device)
    ssum = torch.zeros((b,), dtype=torch.float32, device=device)
    scnt = torch.zeros((b,), dtype=torch.float32, device=device)
    drafted = torch.zeros((), dtype=torch.float32, device=device)
    taken = torch.zeros((), dtype=torch.float32, device=device)
    rounds = 0

    while not bool(finished.all()):
        # draft phase: k proposals; the first step feeds the last two
        # committed tokens (closing the one-token lag after full acceptance)
        logits, draft_cache = draft_step(last2, draft_cache)
        proposals = [torch.argmax(logits[:, -1], dim=-1)]
        for _ in range(k - 1):
            logits, draft_cache = draft_step(proposals[-1][:, None], draft_cache)
            proposals.append(torch.argmax(logits[:, -1], dim=-1))
        drafts = torch.stack(proposals, dim=1)  # [B, k]

        # verify: one target pass over [y_{L-1}, d_1..d_k]
        logits_t, target_cache = target_step(torch.cat([last2[:, 1:], drafts], dim=1),
                                             target_cache)
        lp = torch.log_softmax(logits_t.float(), dim=-1)
        t = torch.argmax(lp, dim=-1)  # [B, k+1]

        # the longest accepted prefix; position acc takes the target's own
        # token (a correction, or the bonus when everything matched)
        acc = torch.cumprod((drafts == t[:, :k]).to(torch.int64), dim=1).sum(dim=1)
        drafts_ext = torch.cat([drafts, t[:, -1:]], dim=1)
        cand = torch.where(j_ids < acc[:, None], drafts_ext, t)  # [B, k+1]

        # committed this round: j <= acc, up to and including the first
        # EOT, within the remaining budget, none once finished
        is_eot = cand == eot_id
        eot_before = torch.cumsum(is_eot.to(torch.int64), dim=1) - is_eot.to(torch.int64)
        remaining = max_new_tokens - (length - p)
        valid = ((~finished)[:, None] & (j_ids <= acc[:, None]) & (eot_before == 0)
                 & (j_ids < remaining[:, None]))
        commits = valid.sum(dim=1)

        offsets = torch.where(valid, (length - p)[:, None] + j_ids, out_w)
        out.scatter_(1, offsets, cand)

        tok_lp = torch.gather(lp, -1, cand[:, :, None])[..., 0]
        ssum = ssum + torch.where(valid, tok_lp, 0.0).sum(dim=1)
        scnt = scnt + commits.to(torch.float32)

        new_length = length + commits
        live = (~finished).to(torch.float32)
        finished = (finished | (valid & is_eot).any(dim=1)
                    | (new_length - p >= max_new_tokens))

        # the last two committed tokens: ext[j] = y_{L-2+j}
        ext = torch.cat([last2, cand], dim=1)  # [B, k+3]
        g = torch.stack([commits, commits + 1], dim=1)
        last2 = torch.where(commits[:, None] >= 1, torch.gather(ext, 1, g.clamp(0, k + 2)),
                            last2)

        # rollback: the index vectors are the cache state
        target_cache = set_cache_index(target_cache, new_length - 1)
        draft_cache = set_cache_index(draft_cache, new_length - 2)
        length = new_length
        drafted = drafted + live.sum() * k
        taken = taken + torch.where(valid & (j_ids < acc[:, None]), 1.0, 0.0).sum()
        rounds += 1

    return SpecDecodeResult(
        tokens=out[:, :max_new_tokens],
        avg_logprob=ssum / scnt.clamp_min(1.0),
        accept_rate=taken / drafted.clamp_min(1.0),
        rounds=rounds,
    )
