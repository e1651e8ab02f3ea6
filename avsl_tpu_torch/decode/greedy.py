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

A greedy decode given the caller's :class:`StepGraphs` (its ``step_fn``
launches device work only and joins no process group) replays one CUDA
graph for every step after the prompt's when the logits are on CUDA,
nothing biases the pick and every self cache's ``index`` is a tensor on
the device (:func:`replays`). The graph holds the step, the pick and the
updates of the loop's state, which live in device buffers the graph
advances in place; only the exit test stays on the host. It is captured
once a decode, over that decode's cache, on the caller's side stream into
its one memory pool, and runs the same kernels on the same values as the
eager loop. Counters: ``decode.graph_captures`` (one a
capture, inside the span ``decode.capture``) and ``decode.graph_replays``
(one a replayed step).

The sampled decode picks ``argmax(logits / T + boost + Gumbel noise)``,
which is what ``jax.random.categorical`` computes, and draws the noise
through :func:`gumbel_noise` from an explicit ``torch.Generator`` (one
``[B, V]`` draw a step, the first step's included), never the global RNG.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from avsl_tpu_torch.core.mesh import draw_rows
from avsl_tpu_torch.decode.biasing import bias_adjust, bias_advance
from avsl_tpu_torch.utils.spans import count, span

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


def _self_caches(cache) -> list:
    """The self-attention caches of a per-block decode cache (a list of
    ``{"self": ...}`` entries), or [] for any other cache."""
    if isinstance(cache, list) and all(isinstance(c, dict) and "self" in c for c in cache):
        return [c["self"] for c in cache]
    return []


def replays(logits, cache, biasing, graphs) -> bool:
    """Whether the loop replays a captured CUDA graph for its steps: the
    caller gave its :class:`StepGraphs` (``graphs``: ``step_fn`` can be
    captured), the prompt step's ``logits`` are on CUDA, no ``biasing``
    steers the pick, and every self cache's ``index`` is a tensor (0-dim
    or [B]), which the step reads on the device (a host integer would bake
    one position into the graph)."""
    if graphs is None or biasing is not None or not logits.is_cuda:
        return False
    selfs = _self_caches(cache)
    return bool(selfs) and all(isinstance(c["index"], torch.Tensor) for c in selfs)


class StepGraphs:
    """What a caller keeps to replay its greedy decode steps as CUDA
    graphs, one captured a decode: a side stream to capture on and one
    memory pool for every capture, both made at the first capture, and the
    last graph. Keeping that graph until the next capture ends keeps the
    pool in use between decodes, so each capture reuses the memory of the
    one before. The lock keeps two threads from capturing into, or
    replaying from, the one pool at once. Passing one to a greedy decode
    says its ``step_fn`` can be captured: it launches device work only and
    joins no process group."""

    def __init__(self):
        self.stream = self.pool = self.graph = None
        self.lock = threading.Lock()

    def capture(self, fn, device) -> torch.cuda.CUDAGraph:
        """``fn``'s device work as a CUDA graph, captured on the side
        stream into the pool (``thread_local``: a producer thread's CUDA
        calls cannot break it); kept as the last graph."""
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with span("decode.capture"), torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                fn()
            finally:
                graph.capture_end()
        self.graph = graph
        count("decode.graph_captures", 1)
        return graph


def _graphed_steps(graphs, step_fn, cache, out, tok, finished, ssum, cnt, eot_id, pick):
    """Steps 1 .. ``max_new_tokens - 1`` of :func:`_decode_loop` as
    replays of one step captured into ``graphs``. ``tok`` [B] (the last
    pick), ``finished``, ``ssum`` and ``cnt`` (None unscored) and ``out``
    are the loop's state in device buffers; the captured step updates
    them, the column of ``out`` it writes and each self cache's index in
    place, with the eager loop's operations in its order. Stops, as that
    loop does, once every row has finished."""
    col = torch.ones((1,), dtype=torch.int64, device=out.device)
    selfs = _self_caches(cache)

    def step():
        logits, new = step_fn(tok[:, None], cache)
        nxt, s = pick(logits[:, -1].float(), None)
        nxt = torch.where(finished, eot_id, nxt)
        if ssum is not None:
            ssum.add_(torch.where(finished, 0.0, s))
            cnt.add_(torch.where(finished, 0.0, 1.0))
        finished.logical_or_(nxt == eot_id)
        out.index_copy_(1, col, nxt[:, None])
        col.add_(1)
        tok.copy_(nxt)
        for c, n in zip(selfs, _self_caches(new)):
            c["index"].copy_(n["index"])

    with graphs.lock:
        graph = graphs.capture(step, out.device)
        for _ in range(1, out.shape[1]):
            with span("decode.sync"):
                done = bool(finished.all())
            if done:
                break
            with span("decode.step"):
                graph.replay()
            count("decode.graph_replays", 1)


def _decode_loop(step_fn, cache, init_tokens, max_new_tokens, eot_id, pick, biasing,
                 graphs=None):
    """The shared loop: ``pick(last fp32 logits [B, V], state) -> (tokens,
    scores or None)``; ``state`` is the biasing state (None without);
    ``graphs``: a :class:`StepGraphs` to replay the steps from where
    :func:`replays` allows. Spans:
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
        graphed = replays(logits, cache, biasing, graphs)
    if graphed:
        del logits  # the prompt's [B, L0, V], which the eager loop drops at its first step
        _graphed_steps(graphs, step_fn, cache, out, first, finished, ssum, cnt, eot_id, pick)
        return out, (ssum / cnt if scored else None)
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
    graphs: Optional[StepGraphs] = None,
) -> torch.Tensor:
    """Autoregressive greedy decode over the KV cache, exiting as soon as
    every sequence has emitted EOT. ``init_tokens`` [B, L0] (the SOT
    prompt) warms the cache in one step; up to ``max_new_tokens`` tokens
    follow, EOT after a sequence's first EOT. ``biasing`` adds its boost to
    the logits before each argmax. ``graphs``: the caller's
    :class:`StepGraphs` (``step_fn`` can be captured), so the steps may
    replay a CUDA graph (:func:`replays`). Returns [B, max_new_tokens]."""
    def pick(last, state):
        if biasing is not None:
            last = last + bias_adjust(biasing, state)
        return torch.argmax(last, dim=-1), None

    out, _ = _decode_loop(step_fn, cache, init_tokens, max_new_tokens, eot_id, pick, biasing,
                          graphs)
    return out


def greedy_decode_scored(
    step_fn: StepFn,
    cache,
    init_tokens: torch.Tensor,
    max_new_tokens: int,
    eot_id: int,
    biasing=None,
    graphs: Optional[StepGraphs] = None,
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

    return _decode_loop(step_fn, cache, init_tokens, max_new_tokens, eot_id, pick, biasing,
                        graphs)


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
