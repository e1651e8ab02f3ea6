"""Contextual biasing (phrase boosting) for the decoders.

Port of ``avsl_tpu/decode/biasing.py``. User phrases (names, jargon) compile
on the host to a token trie whose failure arcs restart at the root, stored
as one dense transition table ``next_node [N, V]`` and a per-node bonus
potential ``bonus [N]``. A decode step's adjustment of the whole vocabulary
is one row gather:

    adj[v] = bonus[next_node[state, v]] - bonus[state]   (+ banked[state] on a failure arc)

Extending a live match earns ``weight`` a token; abandoning a partial match
(EOT included, since ``next_node[s, eot]`` is the root) refunds what it
earned down to the deepest completed phrase on its path (``banked``);
completing a leaf phrase keeps ``weight * len(phrase)`` and returns to the
root (``reset``). A transition is a failure arc when its destination depth
is not ``depth[state] + 1``. The state of a sequence or beam is one integer.

The tables are built as host numpy, exactly as the JAX package builds
them, and uploaded once: ``N * V * 4`` bytes for the transition table.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Union

import numpy as np
import torch


@dataclass(frozen=True)
class BiasingTrie:
    next_node: torch.Tensor  # [N, V] int32: transitions incl. failure arcs
    bonus: torch.Tensor  # [N] float32: accumulated bonus potential
    reset: torch.Tensor  # [N] bool: leaf phrase ends, back to the root
    banked: torch.Tensor  # [N] float32: refund floor (deepest completed end)
    depth: torch.Tensor  # [N] int32: trie depth (root 0)

    @property
    def n_nodes(self) -> int:
        return self.next_node.shape[0]

    @property
    def nbytes(self) -> int:
        """Device bytes of the five tables."""
        return sum(t.numel() * t.element_size() for t in
                   (self.next_node, self.bonus, self.reset, self.banked, self.depth))


def build_biasing_trie(
    phrases: Sequence[Sequence[int]],
    vocab_size: int,
    weight: float = 4.0,
    device: Union[str, torch.device] = "cpu",
) -> BiasingTrie:
    """Compile token-id phrases into a :class:`BiasingTrie` on ``device``.

    ``weight`` is the bonus a token while a phrase matches (a completed
    phrase of length L nets ``weight * L``). A phrase that is a prefix of
    another keeps matching past its end and banks its bonus, so abandoning
    the longer one refunds only down to it. Equal phrases dedupe. The
    tables are built on the host and uploaded once."""
    if not phrases:
        raise ValueError("no phrases")
    w = float(weight)
    if w <= 0:
        raise ValueError(f"weight must be > 0, got {weight}")
    children: list = [{}]
    depth = [0]
    is_end = [False]
    for ph in phrases:
        ph = [int(t) for t in ph]
        if not ph:
            continue
        if any(t < 0 or t >= vocab_size for t in ph):
            raise ValueError(f"phrase token out of range: {ph}")
        node = 0
        for tok in ph:
            nxt = children[node].get(tok)
            if nxt is None:
                nxt = len(children)
                children.append({})
                depth.append(depth[node] + 1)
                is_end.append(False)
                children[node][tok] = nxt
            node = nxt
        is_end[node] = True

    n = len(children)
    # failure arcs restart at the root: child(s, v), else child(root, v),
    # else the root
    root_row = np.zeros((vocab_size,), np.int32)
    for tok, nxt in children[0].items():
        root_row[tok] = nxt
    table = np.tile(root_row, (n, 1))
    for s in range(n):
        for tok, nxt in children[s].items():
            table[s, tok] = nxt
    bonus = np.asarray(depth, np.float32) * w
    # leaf ends bank and reset; interior ends keep matching the longer phrase
    reset = np.asarray([is_end[s] and not children[s] for s in range(n)], bool)
    banked = np.zeros((n,), np.float32)
    frontier = [(0, 0.0)]
    while frontier:
        node, floor = frontier.pop()
        if is_end[node]:
            floor = bonus[node]
        banked[node] = floor
        frontier.extend((c, floor) for c in children[node].values())
    return BiasingTrie(*(torch.from_numpy(a).to(device) for a in
                         (table, bonus, reset, banked, np.asarray(depth, np.int32))))


def bias_adjust(trie: BiasingTrie, state: torch.Tensor) -> torch.Tensor:
    """Score adjustment of the whole vocabulary for each state: int [...]
    -> float32 [..., V], to add to the scores before the argmax or top-k."""
    row = trie.next_node[state].long()  # [..., V]
    adj = trie.bonus[row] - trie.bonus[state][..., None]
    failed = trie.depth[row] != trie.depth[state][..., None] + 1
    return adj + trie.banked[state][..., None] * failed


def bias_advance(trie: BiasingTrie, state: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """The state after emitting ``token``; a leaf phrase end returns to the
    root."""
    nxt = trie.next_node[state, token].long()
    return torch.where(trie.reset[nxt], torch.zeros_like(nxt), nxt)


def encode_phrases(tokenizer, phrases: Sequence[str]) -> list:
    """Token ids of each boost phrase, bare and with a leading space (BPE
    marks a mid-sentence word with one), for :func:`build_biasing_trie`."""
    out = []
    for p in phrases:
        p = p.strip()
        if not p:
            continue
        for form in (p, " " + p):
            ids = tokenizer.encode(form)
            if ids:
                out.append(ids)
    if not out:
        raise ValueError("no non-empty boost phrases")
    return out
