"""Batched KV-cached beam search.

Port of ``avsl_tpu/decode/beam.py::beam_search``. The JAX
``lax.while_loop`` becomes a Python loop with the same early exit (stop
once every beam of every item is finished; the exit test reads one
boolean from the device each step), and the same rules: finished beams
may only extend with EOT at zero added score, beams reorder by their
source beam each step, and the final pick is length-normalised.

The port's decode caches are written in place and carry their write
position as a host integer ``index`` (``models/layers.py``). Reordering
beams therefore gathers every cache tensor into a new tensor (never a
view of the old one) and carries the integers through unchanged.

Generic over models: ``step_fn(tokens [N, L], cache) -> (logits [N, L, V],
cache)``. Contextual biasing (``biasing``) waits for
``decode/biasing.py`` (ROADMAP.md queue 1, item 11).
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

NEG_INF = -1.0e9


def _map_cache(tree: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    """Apply ``fn`` to every batched tensor of a cache tree (lists and
    dicts); scalars and host integers pass through."""
    if isinstance(tree, dict):
        return {k: _map_cache(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_cache(v, fn) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.ndim > 0:
        return fn(tree)
    return tree


def _tile_beams(tree: Any, beam_size: int) -> Any:
    """Repeat every batched leaf K times along dim 0."""
    return _map_cache(tree, lambda x: x.repeat_interleave(beam_size, dim=0))


def _gather_beams(tree: Any, flat_idx: torch.Tensor) -> Any:
    """Reorder batched leaves by flat [B*K] source indices, into new tensors."""
    return _map_cache(tree, lambda x: x.index_select(0, flat_idx))


def beam_search(
    step_fn: Callable,
    cache: Any,
    init_tokens: torch.Tensor,
    beam_size: int,
    max_new_tokens: int,
    eot_id: int,
    length_penalty: float = 1.0,
    return_nbest: bool = False,
    biasing=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run beam search; returns (best sequences [B, max_new_tokens], best
    length-normalised log-prob scores [B]), or with ``return_nbest`` all K
    hypotheses best-first ([B, K, max_new_tokens], [B, K]).

    ``cache`` has batch dim B (it is tiled to B*K here); ``init_tokens``
    [B, L0] is the prompt fed once to warm the cache."""
    if biasing is not None:
        raise NotImplementedError(
            "biasing: contextual phrase boosting is not ported yet "
            "(ROADMAP.md queue 1, item 11: decode/biasing.py)"
        )
    b = init_tokens.shape[0]
    k = beam_size

    logits, cache = step_fn(init_tokens, cache)
    log_probs = torch.log_softmax(logits[:, -1].float(), dim=-1)
    vocab = log_probs.shape[-1]
    device = log_probs.device
    scores, first_tokens = torch.topk(log_probs, k, dim=-1)  # [B, K]
    cache = _tile_beams(cache, k)

    seqs = torch.full((b, k, max_new_tokens), eot_id, dtype=torch.int64, device=device)
    seqs[:, :, 0] = first_tokens
    finished = first_tokens == eot_id
    eot_only = torch.full((vocab,), NEG_INF, device=device)
    eot_only[eot_id] = 0.0
    batch_offset = (torch.arange(b, device=device) * k)[:, None]
    last, i = first_tokens, 1
    while i < max_new_tokens and not bool(finished.all()):
        logits, cache = step_fn(last.reshape(b * k, 1), cache)
        lp = torch.log_softmax(logits[:, -1].float(), dim=-1).reshape(b, k, vocab)
        # finished beams may only extend with EOT at zero added score
        lp = torch.where(finished[:, :, None], eot_only, lp)
        total = scores[:, :, None] + lp  # [B, K, V]
        scores, flat_idx = torch.topk(total.reshape(b, k * vocab), k, dim=-1)
        beam_src = flat_idx // vocab  # [B, K] source beam
        new_tok = flat_idx % vocab
        seqs = torch.gather(seqs, 1, beam_src[:, :, None].expand(-1, -1, max_new_tokens))
        seqs[:, :, i] = new_tok
        cache = _gather_beams(cache, (batch_offset + beam_src).reshape(-1))
        finished = torch.gather(finished, 1, beam_src) | (new_tok == eot_id)
        last, i = new_tok, i + 1

    # length-normalised selection, counting tokens up to and including EOT;
    # a beam that never emitted EOT counts max_new_tokens
    lengths = ((seqs == eot_id).cumsum(-1) == 0).sum(-1) + 1
    lengths = lengths.clamp(max=max_new_tokens)
    norm = scores / lengths.float().pow(length_penalty)
    if return_nbest:
        order = torch.argsort(-norm, dim=1, stable=True)
        nbest = torch.gather(seqs, 1, order[:, :, None].expand(-1, -1, max_new_tokens))
        return nbest, torch.gather(norm, 1, order)
    best = torch.argmax(norm, dim=1)
    return seqs[torch.arange(b, device=device), best], norm[torch.arange(b, device=device), best]
