"""GPipe pipeline parallelism over a ``stage`` mesh axis.

Port of ``avsl_tpu/core/pipeline.py``. JAX runs the fill-drain schedule
as one program, a scan over ticks inside a ``shard_map`` with ``ppermute``
hand-offs, and derives its backward. Here each rank is a process
(``core/mesh.py``) and the schedule is written out, forward and backward:

* :func:`stack_block_params` stacks the per-layer subtrees of identical
  blocks on a leading layer axis ``[L, ...]``; a :class:`StackedBlocks`
  owns such tensors as parameters, named as one block's, so that a train
  state's model and optimizer hold them; :func:`make_pp_mesh` builds the
  ``(data, stage)`` mesh, each stage owning ``L / S`` contiguous layers
  (``train/pp.py::shard_pp_state`` keeps them).
* :func:`pipeline_apply` takes this data rank's rows, whole on every
  stage rank, splits them into microbatches and runs them through the
  stages in order. Stage ``s`` runs its layers on microbatch ``t - s`` at
  tick ``t``; the bubble ticks, where JAX computes zeros it discards, are
  skipped. Activations go to stage ``s + 1`` by point-to-point sends,
  one ``batch_isend_irecv`` a tick that also receives the next
  microbatch, so neighbours always post matching pairs. ``extras`` are not
  sent: every stage rank holds the whole batch and slices its
  microbatch. The last stage's outputs are broadcast over the stage
  group, so every stage rank returns the same whole output, as JAX's
  masked ``psum`` makes it.
* The backward is the reverse schedule, in an autograd ``Function``: the
  forward keeps each microbatch's graph (no recompute), the last stage
  takes its own cotangent of the broadcast output (each stage rank holds
  the same one, and it is counted once), gradients of each stage's input
  go back by point-to-point, the gradient of ``x`` is stage 0's,
  broadcast, and a floating-point leaf of ``extras`` gets the sum over
  stages of its uses. So a replicated tensor before or after the pipeline
  gets the same gradient on every stage rank, and a train step reduces
  nothing over the stage group.

Microbatches are formed from each data rank's rows (JAX splits each
microbatch over the data axis); the blocks treat rows independently, so
the outputs and the summed gradients are the same. The blocks run
deterministically (their template in eval mode), as JAX's pipeline runs
them.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.utils import _pytree as pytree

from avsl_tpu_torch.core.mesh import DATA_AXIS, STAGE_AXIS, Mesh, make_mesh

__all__ = [
    "STAGE_AXIS",
    "StackedBlocks",
    "make_block_fn",
    "make_pp_mesh",
    "pipeline_apply",
    "stack_block_params",
    "unstack_block_params",
]

# block_fn(layer_params, h, extras_mb) -> h
BlockFn = Callable[[Dict[str, torch.Tensor], torch.Tensor, Any], torch.Tensor]


def make_pp_mesh(n_devices: Optional[int] = None, stages: int = 1) -> Mesh:
    """The ``(data, stage)`` mesh over the joined process group: ``stages``
    contiguous ranks a pipeline (``reshape(n // stages, stages)``, as in
    JAX). ``n_devices`` (the world size when None) must be the world size
    (``core/mesh.py::make_mesh``)."""
    n = (dist.get_world_size() if dist.is_initialized() else 1) if n_devices is None \
        else int(n_devices)
    if n % stages != 0:
        raise ValueError(f"n_devices={n} not divisible by stages={stages}")
    mesh = make_mesh(n, model_parallel=stages, axis_names=(DATA_AXIS, STAGE_AXIS))
    if stages > 1:
        # NCCL wants every rank of a group in its first call; the schedule's
        # first point-to-point pairs involve two stages only
        dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.stage_group)
    return mesh


# ---------------------------------------------------------------------------
# stacked parameters
# ---------------------------------------------------------------------------


def _flat(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested mapping of tensors -> ``{"a.b.c": tensor}``."""
    if not isinstance(tree, Mapping):
        return {prefix[:-1]: tree}
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        out.update(_flat(value, f"{prefix}{key}."))
    return out


def _nest(flat: Mapping[str, torch.Tensor]) -> dict:
    """``{"a.b.c": tensor}`` -> a nested dict."""
    out: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split(".")
        node = out
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = value
    return out


def stack_block_params(params: Mapping, n_layers: int, fmt: str = "block_{}"):
    """Stack the subtrees ``fmt.format(i)`` of a nested dict of tensors
    into one tree whose leaves carry a leading layer axis ``[L, ...]``.
    Returns ``(stacked, rest)``, ``rest`` being ``params`` without the
    layer subtrees. Raises KeyError on a missing layer."""
    names = [fmt.format(i) for i in range(n_layers)]
    missing = [n for n in names if n not in params]
    if missing:
        raise KeyError(f"layer subtrees not found in params: {missing}")
    per_layer = [_flat(params[n]) for n in names]
    stacked = {key: torch.stack([layer[key] for layer in per_layer]) for key in per_layer[0]}
    rest = {k: v for k, v in params.items() if k not in set(names)}
    return _nest(stacked), rest


def unstack_block_params(stacked, n_layers: int, fmt: str = "block_{}") -> dict:
    """Inverse of :func:`stack_block_params` (checkpoint export)."""
    flat = _flat(stacked)
    for key, t in flat.items():
        if t.shape[0] < n_layers:
            raise KeyError(f"{key} holds {t.shape[0]} layers, not {n_layers}")
    return {fmt.format(i): _nest({k: t[i] for k, t in flat.items()}) for i in range(n_layers)}


def make_block_fn(block: nn.Module) -> BlockFn:
    """``block_fn(layer_params, h, extras_mb)`` that applies ``block``'s
    module (a copy on the meta device, in eval mode) to one layer's
    tensors through ``torch.func.functional_call``; ``extras_mb`` (a dict
    or None) is passed as keyword arguments of its forward, and a tuple
    output gives its first element."""
    template = copy.deepcopy(block).to("meta").eval()

    def block_fn(layer_params, h, extras_mb=None):
        out = torch.func.functional_call(template, layer_params, (h,), dict(extras_mb or {}))
        return out[0] if isinstance(out, tuple) else out

    return block_fn


def _register(root: nn.Module, key: str, param: nn.Parameter) -> None:
    *path, leaf = key.split(".")
    node = root
    for name in path:
        if name not in node._modules:
            node.add_module(name, nn.Module())
        node = node._modules[name]
    node.register_parameter(leaf, param)


class StackedBlocks(nn.Module):
    """The tensors of ``n_layers`` identical blocks stacked on a leading
    layer axis, as parameters named as one block's (``attn.query.weight``
    of shape ``[L, ...]``), and :attr:`block_fn`, which applies ``block``'s
    module to one layer's slice. ``rows = (first, count)`` are the layers
    held: all of them, or a stage's once ``train/pp.py::shard_pp_state``
    has cut them. ``stacked`` is a nested dict of ``[L, ...]`` tensors
    (:func:`stack_block_params`)."""

    def __init__(self, block: nn.Module, stacked: Mapping):
        super().__init__()
        flat = _flat(stacked)
        self.n_layers = int(next(iter(flat.values())).shape[0])
        self.rows: Tuple[int, int] = (0, self.n_layers)
        self.block_fn = make_block_fn(block)
        for key, t in flat.items():
            if t.shape[0] != self.n_layers:
                raise ValueError(f"{key}: {t.shape[0]} layers, not {self.n_layers}")
            _register(self, key, nn.Parameter(t.detach()))


def _stage_tensors(stacked, n_stages: int, stage: int) -> Dict[str, torch.Tensor]:
    """Stage ``stage``'s rows of each stacked tensor: a
    :class:`StackedBlocks`' own when it holds exactly them, else a slice of
    every layer's (differentiable)."""
    if isinstance(stacked, StackedBlocks):
        params, n_layers, rows = dict(stacked.named_parameters()), stacked.n_layers, stacked.rows
    else:
        params = _flat(stacked)
        n_layers = int(next(iter(params.values())).shape[0])
        rows = (0, n_layers)
    if n_layers % n_stages != 0:
        raise ValueError(f"{n_layers} layers not divisible by {n_stages} stages")
    per = n_layers // n_stages
    want = (stage * per, per)
    if rows == want:
        return params
    if rows != (0, n_layers):
        raise ValueError(f"the stacked tensors hold layers {rows}; stage {stage} runs {want}")
    return {k: p.narrow(0, want[0], per) for k, p in params.items()}


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


def _exchange(group, send: Optional[Tuple[torch.Tensor, int]],
              recv: Optional[Tuple[torch.Tensor, int]]) -> None:
    """One tick's point-to-point: send and receive (each optional) posted
    together and waited on."""
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send[0].contiguous(), send[1], group))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv[0], recv[1], group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def _buffer(like: torch.Tensor) -> torch.Tensor:
    """A contiguous receive buffer of ``like``'s shape and dtype."""
    return torch.empty(like.shape, dtype=like.dtype, device=like.device)


def _check_kept(h: torch.Tensor, h_in: torch.Tensor) -> None:
    if h.shape != h_in.shape or h.dtype != h_in.dtype:
        raise ValueError(f"a stage maps {tuple(h_in.shape)} {h_in.dtype} to {tuple(h.shape)} "
                         f"{h.dtype}: pipelined blocks keep their input's shape and dtype")


class _Schedule:
    """One call's fill-drain schedule on this rank: its stage, neighbours
    and microbatches, and the graphs the backward replays."""

    def __init__(self, block_fn: BlockFn, names: List[str], extras_spec, mesh: Mesh,
                 n_microbatches: int):
        self.block_fn, self.names, self.extras_spec = block_fn, names, extras_spec
        self.m = n_microbatches
        self.n_stages, self.stage = mesh.shape[STAGE_AXIS], mesh.stage_rank
        self.group = mesh.stage_group
        if self.n_stages > 1:
            rank_of = lambda s: dist.get_global_rank(self.group, s)  # noqa: E731
            self.prev = rank_of(self.stage - 1) if self.stage > 0 else None
            self.next = rank_of(self.stage + 1) if self.stage < self.n_stages - 1 else None
            self.first, self.last = rank_of(0), rank_of(self.n_stages - 1)
        else:
            self.prev = self.next = None
        self.saved: list = []

    def _stage(self, h: torch.Tensor, layers: Sequence[Sequence[torch.Tensor]],
               extras_mb) -> torch.Tensor:
        for layer in layers:
            h = self.block_fn(dict(zip(self.names, layer)), h, extras_mb)
        return h

    def forward(self, x: torch.Tensor, extras: List[torch.Tensor],
                params: Sequence[torch.Tensor], keep: bool) -> torch.Tensor:
        """The forward schedule; with ``keep`` each microbatch's graph is
        built on leaves detached from its inputs, one a layer for each
        stacked tensor (so that the backward makes each layer's gradient
        alone, not a whole stacked tensor a layer), and kept for
        :meth:`backward`."""
        last = self.stage == self.n_stages - 1
        xs = x.split(x.shape[0] // self.m)
        layers = [[p[i] for p in params] for i in range(params[0].shape[0] if params else 0)]
        if keep:
            extras = [e.detach().requires_grad_(e.requires_grad) for e in extras]
            layers = [[t.detach().requires_grad_(p.requires_grad) for t, p in zip(layer, params)]
                      for layer in layers]
            self.extras, self.layers, self.params = extras, layers, params
        extras_mb = [e.split(e.shape[0] // self.m) for e in extras]
        outs, pending = [], None
        for m in range(self.m):
            h_in = xs[m] if self.stage == 0 else _buffer(xs[m])
            _exchange(self.group, None if pending is None else (pending, self.next),
                      None if self.stage == 0 else (h_in, self.prev))
            if keep:
                h_in = h_in.detach().requires_grad_(self.stage > 0 or x.requires_grad)
            e = None if self.extras_spec is None else \
                pytree.tree_unflatten([leaf[m] for leaf in extras_mb], self.extras_spec)
            with torch.set_grad_enabled(keep):
                h = self._stage(h_in, layers, e)
            _check_kept(h, h_in)
            if keep:
                self.saved.append((h_in, h))
            if last:
                outs.append(h.detach())
            else:
                pending = h.detach()
        if pending is not None:
            _exchange(self.group, (pending, self.next), None)
        if self.n_stages == 1:
            return torch.cat(outs)
        out = torch.cat(outs) if last else _buffer(x)
        dist.broadcast(out, self.last, group=self.group)
        return out

    def backward(self, g_out: torch.Tensor, needs: Tuple[bool, List[bool], List[bool]]):
        """The reverse schedule: ``(grad of x, grads of extras, grads of
        params)`` (None where not needed)."""
        needs_x, needs_e, needs_p = needs
        last = self.stage == self.n_stages - 1
        gs = g_out.split(g_out.shape[0] // self.m) if last else None
        grads_e: List[Optional[torch.Tensor]] = [None] * len(self.extras)
        want_e = [i for i, e in enumerate(self.extras) if e.requires_grad]
        want_p = [j for j, p in enumerate(self.params) if p.requires_grad]
        grads_l: List[List[Optional[torch.Tensor]]] = [[None] * len(self.params)
                                                        for _ in self.layers]
        gx: List[Optional[torch.Tensor]] = [None] * self.m
        pending = None
        for m in reversed(range(self.m)):
            h_in, h = self.saved[m]
            g = gs[m] if last else _buffer(h)
            _exchange(self.group, None if pending is None else (pending, self.prev),
                      None if last else (g, self.next))
            inputs = [h_in] if h_in.requires_grad else []
            inputs += [self.extras[i] for i in want_e]
            inputs += [layer[j] for layer in self.layers for j in want_p]
            got = list(torch.autograd.grad(h, inputs, g, allow_unused=True))
            if h_in.requires_grad:
                g_in = got.pop(0)
                g_in = torch.zeros_like(h_in) if g_in is None else g_in
                if self.stage > 0:
                    pending = g_in
                else:
                    gx[m] = g_in
            targets = [(grads_e, i) for i in want_e]
            targets += [(acc, j) for acc in grads_l for j in want_p]
            for (acc, i), grad in zip(targets, got):
                if grad is not None:
                    acc[i] = grad if acc[i] is None else acc[i] + grad
            self.saved[m] = None
        if pending is not None:
            _exchange(self.group, (pending, self.prev), None)
        grad_x = None
        if needs_x:
            grad_x = torch.cat(gx) if self.stage == 0 else _buffer(g_out)
            if self.n_stages > 1:
                dist.broadcast(grad_x, self.first, group=self.group)
        for i in want_e:
            grads_e[i] = torch.zeros_like(self.extras[i]) if grads_e[i] is None \
                else grads_e[i].contiguous()
            if self.n_stages > 1:
                dist.all_reduce(grads_e[i], group=self.group)
        grads_e = [g if n else None for g, n in zip(grads_e, needs_e)]
        grads_p = [torch.stack([torch.zeros_like(layer[j]) if acc[j] is None else acc[j]
                                for layer, acc in zip(self.layers, grads_l)]) if n else None
                   for j, n in enumerate(needs_p)]
        self.saved = []
        return grad_x, grads_e, grads_p


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, schedule: _Schedule, n_extras: int, x, *tensors):
        ctx.schedule, ctx.n_extras = schedule, n_extras
        extras, params = list(tensors[:n_extras]), tensors[n_extras:]
        return schedule.forward(x, extras, params, keep=True)

    @staticmethod
    def backward(ctx, g_out):
        n = ctx.n_extras
        needs = ctx.needs_input_grad
        grad_x, grads_e, grads_p = ctx.schedule.backward(
            g_out.contiguous(), (needs[2], list(needs[3:3 + n]), list(needs[3 + n:])))
        return (None, None, grad_x, *grads_e, *grads_p)


def pipeline_apply(block_fn: BlockFn, stacked_params, x: torch.Tensor, *, mesh: Mesh,
                   n_microbatches: int, extras: Any = None) -> torch.Tensor:
    """Run ``x`` through a pipelined stack of identical blocks.

    Args:
      block_fn: ``(layer_params, h, extras_mb) -> h``, one layer (e.g.
        :meth:`StackedBlocks.block_fn` or :func:`make_block_fn`);
        ``extras_mb`` is the microbatch's slice of ``extras`` (or None). A
        block keeps its input's shape and dtype.
      stacked_params: a :class:`StackedBlocks`, or a nested dict of
        ``[L, ...]`` tensors; ``L`` must divide by the stage count. Each
        stage runs its ``L / S`` contiguous layers.
      x: ``[B, ...]``, this data rank's rows, whole on every stage rank; B
        must divide by ``n_microbatches``.
      mesh: a mesh with a ``stage`` axis (:func:`make_pp_mesh`).
      extras: an optional pytree of ``[B, ...]`` tensors (masks, lengths)
        riding along with each microbatch.

    Returns the ``[B, ...]`` outputs, whole and identical on every stage
    rank; differentiable with respect to the stacked tensors, ``x`` and
    the floating-point leaves of ``extras``.
    """
    n_stages = mesh.shape[STAGE_AXIS]
    local = _stage_tensors(stacked_params, n_stages, mesh.stage_rank)
    leaves, spec = pytree.tree_flatten(extras) if extras is not None else ([], None)
    for leaf in [x, *leaves]:
        if leaf.shape[0] % n_microbatches != 0:
            raise ValueError(f"batch {leaf.shape[0]} not divisible by "
                             f"n_microbatches={n_microbatches}")
    names = list(local)
    params = [local[n] for n in names]
    schedule = _Schedule(block_fn, names, spec, mesh, n_microbatches)
    if torch.is_grad_enabled() and any(t.requires_grad for t in [x, *leaves, *params]):
        return _Pipeline.apply(schedule, len(leaves), x, *leaves, *params)
    with torch.no_grad():
        return schedule.forward(x, leaves, params, keep=False)
