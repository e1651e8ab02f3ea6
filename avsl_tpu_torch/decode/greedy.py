"""Greedy decoding: teacher-forced eval and the KV-cached autoregressive loop.

Port of ``avsl_tpu/decode/greedy.py`` (``mask_after_eot``,
``teacher_forced_predictions``, ``greedy_decode``,
``greedy_decode_scored``). The JAX ``lax.while_loop`` becomes a Python
loop with the same early exit (stop once every sequence has emitted EOT)
and the same score and count rules. The exit test reads one boolean from
the device each step.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

# step_fn(tokens [B, L], cache) -> (logits [B, L, V], cache)
StepFn = Callable


def mask_after_eot(tokens: torch.Tensor, eot_id: int) -> torch.Tensor:
    """Replace every token after the first EOT with EOT."""
    is_eot = (tokens == eot_id).to(torch.int32)
    after = torch.cumsum(is_eot, dim=-1) - is_eot
    return torch.where(after > 0, torch.full_like(tokens, eot_id), tokens)


def teacher_forced_predictions(logits: torch.Tensor, eot_id: int) -> torch.Tensor:
    """argmax over teacher-forced logits, EOT tail-masked. [B,T,V] -> [B,T]."""
    return mask_after_eot(torch.argmax(logits, dim=-1), eot_id)


def _decode_loop(step_fn, cache, init_tokens, max_new_tokens, eot_id, scored):
    def pick(logits):
        last = logits[:, -1].float()
        if not scored:
            return torch.argmax(last, dim=-1), None
        lp = torch.log_softmax(last, dim=-1)
        tok = torch.argmax(lp, dim=-1)
        return tok, torch.gather(lp, 1, tok[:, None])[:, 0]

    logits, cache = step_fn(init_tokens, cache)
    first, ssum = pick(logits)
    b = first.shape[0]
    cnt = torch.ones((b,), dtype=torch.float32, device=first.device)
    finished = first == eot_id
    out = torch.full((b, max_new_tokens), eot_id, dtype=first.dtype, device=first.device)
    out[:, 0] = first
    tok, i = first, 1
    while i < max_new_tokens and not bool(finished.all()):
        logits, cache = step_fn(tok[:, None], cache)
        nxt, s = pick(logits)
        if scored:
            ssum = ssum + torch.where(finished, 0.0, s)
            cnt = cnt + torch.where(finished, 0.0, 1.0)
        nxt = torch.where(finished, eot_id, nxt)
        finished = finished | (nxt == eot_id)
        out[:, i] = nxt
        tok, i = nxt, i + 1
    return out, (ssum / cnt if scored else None)


def greedy_decode(
    step_fn: StepFn,
    cache,
    init_tokens: torch.Tensor,
    max_new_tokens: int,
    eot_id: int,
) -> torch.Tensor:
    """Autoregressive greedy decode over the KV cache, exiting as soon as
    every sequence has emitted EOT. ``init_tokens`` [B, L0] (the SOT
    prompt) warms the cache in one step; up to ``max_new_tokens`` tokens
    follow, EOT after a sequence's first EOT. Returns [B, max_new_tokens]."""
    out, _ = _decode_loop(step_fn, cache, init_tokens, max_new_tokens, eot_id, False)
    return out


def greedy_decode_scored(
    step_fn: StepFn,
    cache,
    init_tokens: torch.Tensor,
    max_new_tokens: int,
    eot_id: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`greedy_decode` plus the per-sequence mean token
    log-probability over the generated tokens up to and including the
    first EOT. Returns (tokens [B, max_new_tokens], avg_logprob [B] fp32)."""
    return _decode_loop(step_fn, cache, init_tokens, max_new_tokens, eot_id, True)
