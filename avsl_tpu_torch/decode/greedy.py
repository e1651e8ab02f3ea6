"""Greedy and sampled decoding: teacher-forced eval and the KV-cached
autoregressive loops.

Port of ``avsl_tpu/decode/greedy.py`` (``mask_after_eot``,
``teacher_forced_predictions``, ``greedy_decode``, ``greedy_decode_scored``,
``sampled_decode_scored``). The JAX ``lax.while_loop`` becomes a Python
loop with the same early exit (stop once every sequence has emitted EOT)
and the same score and count rules. The exit test reads one boolean from
the device each step. ``biasing`` (a :class:`~.biasing.BiasingTrie`) adds
the phrase boost to the scores before each pick; the reported score stays
the model's own log-probability.

The sampled decode picks ``argmax(logits / T + boost + Gumbel noise)``,
which is what ``jax.random.categorical`` computes, and draws the noise
through :func:`gumbel_noise` from an explicit ``torch.Generator`` (one
``[B, V]`` draw a step, the first step's included), never the global RNG.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from avsl_tpu_torch.core.mesh import draw_rows
from avsl_tpu_torch.decode.biasing import bias_adjust, bias_advance
from avsl_tpu_torch.utils.spans import span

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


def gumbel_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, ``u`` uniform on [tiny, 1)
    in fp32, drawn from ``generator`` on ``device`` over the rows of
    ``shape`` (``core/mesh.py::draw_rows``: at the whole batch's shape on
    a mesh's data rank)."""
    u = draw_rows(lambda s: torch.rand(s, generator=generator, device=device,
                                       dtype=torch.float32), shape)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))


def _decode_loop(step_fn, cache, init_tokens, max_new_tokens, eot_id, pick, biasing):
    """The shared loop: ``pick(last fp32 logits [B, V], state) -> (tokens,
    scores or None)``; ``state`` is the biasing state (None without). Spans:
    ``decode.prefill`` (the prompt step and first pick), ``decode.step``
    (each later step) and ``decode.sync`` (the host's read of whether every
    row has finished, skipped once ``max_new_tokens`` are out)."""
    with span("decode.prefill"):
        logits, cache = step_fn(init_tokens, cache)
        b = logits.shape[0]
        device = logits.device
        state = None if biasing is None else torch.zeros((b,), dtype=torch.int64, device=device)
        first, ssum = pick(logits[:, -1].float(), state)
        if biasing is not None:
            state = bias_advance(biasing, state, first)
        scored = ssum is not None
        cnt = torch.ones((b,), dtype=torch.float32, device=device)
        finished = first == eot_id
        out = torch.full((b, max_new_tokens), eot_id, dtype=first.dtype, device=device)
        out[:, 0] = first
    tok, i = first, 1
    while i < max_new_tokens:
        with span("decode.sync"):
            done = bool(finished.all())
        if done:
            break
        with span("decode.step"):
            logits, cache = step_fn(tok[:, None], cache)
            nxt, s = pick(logits[:, -1].float(), state)
            nxt = torch.where(finished, eot_id, nxt)
            if biasing is not None:
                state = bias_advance(biasing, state, nxt)
            if scored:
                ssum = ssum + torch.where(finished, 0.0, s)
                cnt = cnt + torch.where(finished, 0.0, 1.0)
            finished = finished | (nxt == eot_id)
            out[:, i] = nxt
            tok, i = nxt, i + 1
    return out, (ssum / cnt if scored else None)


def _token_scores(lp: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    return torch.gather(lp, 1, tok[:, None])[:, 0]


def greedy_decode(
    step_fn: StepFn,
    cache,
    init_tokens: torch.Tensor,
    max_new_tokens: int,
    eot_id: int,
    biasing=None,
) -> torch.Tensor:
    """Autoregressive greedy decode over the KV cache, exiting as soon as
    every sequence has emitted EOT. ``init_tokens`` [B, L0] (the SOT
    prompt) warms the cache in one step; up to ``max_new_tokens`` tokens
    follow, EOT after a sequence's first EOT. ``biasing`` adds its boost to
    the logits before each argmax. Returns [B, max_new_tokens]."""
    def pick(last, state):
        if biasing is not None:
            last = last + bias_adjust(biasing, state)
        return torch.argmax(last, dim=-1), None

    out, _ = _decode_loop(step_fn, cache, init_tokens, max_new_tokens, eot_id, pick, biasing)
    return out


def greedy_decode_scored(
    step_fn: StepFn,
    cache,
    init_tokens: torch.Tensor,
    max_new_tokens: int,
    eot_id: int,
    biasing=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`greedy_decode` plus the per-sequence mean token
    log-probability over the generated tokens up to and including the
    first EOT. ``biasing`` steers the argmax; the score is the model's own
    log-probability of the chosen tokens. Returns (tokens [B,
    max_new_tokens], avg_logprob [B] fp32)."""
    def pick(last, state):
        lp = torch.log_softmax(last, dim=-1)
        tok = torch.argmax(lp if biasing is None else lp + bias_adjust(biasing, state), dim=-1)
        return tok, _token_scores(lp, tok)

    return _decode_loop(step_fn, cache, init_tokens, max_new_tokens, eot_id, pick, biasing)


def sampled_decode_scored(
    step_fn: StepFn,
    cache,
    init_tokens: torch.Tensor,
    max_new_tokens: int,
    eot_id: int,
    temperature: float,
    generator: torch.Generator,
    biasing=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Temperature sampling with the contract of :func:`greedy_decode_scored`.

    Each step picks ``argmax(logits / T + boost + noise)`` with ``T``
    clamped at 1e-6 and the noise from :func:`gumbel_noise` on
    ``generator``; the score is the sampled token's untempered
    log-probability, as the fallback compares retries with the greedy pass.
    Returns (tokens [B, max_new_tokens], avg_logprob [B] fp32)."""
    t = torch.tensor(max(np.float32(temperature), np.float32(1e-6)), dtype=torch.float32)

    def pick(last, state):
        lp = torch.log_softmax(last, dim=-1)
        tempered = last / t  # a 0-dim CPU tensor joins a CUDA op as a scalar
        if biasing is not None:
            tempered = tempered + bias_adjust(biasing, state)
        noise = gumbel_noise(generator, tuple(last.shape), last.device)
        tok = torch.argmax(noise + tempered, dim=-1)
        return tok, _token_scores(lp, tok)

    return _decode_loop(step_fn, cache, init_tokens, max_new_tokens, eot_id, pick, biasing)
