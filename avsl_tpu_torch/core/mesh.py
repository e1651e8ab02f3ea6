"""The (data, model), (data, expert) or (data, stage) process grid and the
batch and collective helpers.

Port of ``avsl_tpu/core/mesh.py``. JAX runs one process over every device
and shards arrays by annotation; PyTorch runs one process per rank
(``python -m torch.distributed.run --nproc_per_node N ...``), so here:

* :func:`init_distributed` joins the launcher's process group: ``nccl``
  on a card (the rank's device is ``cuda:LOCAL_RANK``), ``gloo`` on the
  CPU. There is no fallback from one to the other.
* :func:`make_mesh` lays the ranks out as JAX's ``reshape(n // mp, mp)``
  does: ``model_parallel`` contiguous ranks share the second axis, named
  ``axis_names[1]`` (``"model"``, ``"expert"`` for
  ``models/moe.py::make_ep_mesh``, or ``"stage"`` for
  ``core/pipeline.py::make_pp_mesh``). The :class:`Mesh` holds ``.shape``
  (``{"data": dp, "model": mp}``, ``{"data": dp, "expert": ep}`` or
  ``{"data": dp, "stage": pp}``, as ``jax.sharding.Mesh.shape``) over a
  ``torch.distributed`` ``DeviceMesh``
  and this rank's coordinates and groups. The MoE layer holds its own
  experts' slice of the ``[E, C, D]`` blocks on an expert axis
  (``models/moe.py``), so :func:`constrain_activation` splits only over
  the model axis.
* :func:`shard_batch` hands each data rank its rows of the global batch;
  a leaf whose batch dim does not divide the data axis, or a 0-d leaf, is
  given whole to every rank, as JAX replicates it.
* Random draws over rows (dropout, SpecAugment, span masks) go through
  :func:`draw_rows`: inside :func:`row_shard_scope` each rank draws at the
  global batch's shape from a generator seeded alike on every rank and
  keeps its own rows, so a data-parallel step draws the single-device
  step's numbers and every rank's generator stays in step with the
  others; a dim split over the model axis (attention dropout on local
  heads) keeps its own slice the same way. Draws once a step or once a
  layer (LayerDrop, the AV-mode draw) use the generator directly and
  agree on every rank.
* The autograd collectives of tensor parallelism and synchronised
  BatchNorm: :func:`copy_to_group`, :func:`reduce_from_group`,
  :func:`gather_from_group` and :func:`all_reduce_sum`.
* Sequence parallelism (Megatron's, JAX's ``core/mesh.py:86-155``):
  inside :func:`activation_sharding_scope` (which the train and eval
  steps enter themselves) :func:`constrain_activation` splits an
  encoder's [B, T, D] activations over T on the model group between
  blocks and returns the :class:`SequenceSplit` it made (an axis of size
  1, or one that does not divide T, is dropped, as in JAX, and the
  activations stay whole). A block run under the
  split (:func:`sequence_split_scope`) all-gathers T before its
  column-parallel products and reduce-scatters after its row-parallel
  ones (``models/layers.py``); the rows of a batch are already this data
  rank's (:func:`shard_batch`), so the data axis needs nothing here.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
EXPERT_AXIS = "expert"
STAGE_AXIS = "stage"
SECOND_AXES = (MODEL_AXIS, EXPERT_AXIS, STAGE_AXIS)


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one mesh axis name (or None) per
    dim of an array, in the JAX package's (flax) layout."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def init_distributed(device) -> torch.device:
    """Join the process group that ``torch.distributed.run`` describes in
    the environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``) and return this rank's device:
    ``cuda:LOCAL_RANK`` over ``nccl`` when ``device`` is a CUDA device,
    the CPU over ``gloo`` when it is the CPU. Outside the launcher, or in
    a group already joined, nothing is joined and ``device`` comes back
    as it is (a CUDA device then on its index)."""
    device = torch.device(device)
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device}")
    dist.init_process_group(backend, init_method="env://")
    return device


def world_size() -> int:
    """Ranks in the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """A (data, model), (data, expert) or (data, stage) grid of ranks:
    ``shape`` as ``Mesh.shape`` in JAX, ``axis`` the second axis's name,
    this rank's ``data_rank`` and the group of its column
    (``data_group``), the ``DeviceMesh`` and this rank's ``device``. The
    second axis's rank and group (its row) are ``model_rank``/
    ``model_group``, ``expert_rank``/``expert_group`` or ``stage_rank``/
    ``stage_group``, after its name; the other pairs are 0 and None (an
    axis of size 1, over which every collective is the identity)."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        dp, n = device_mesh.shape
        self.axis = device_mesh.mesh_dim_names[1]
        if self.axis not in SECOND_AXES:
            raise ValueError(f"second mesh axis {self.axis!r}: one of {SECOND_AXES}")
        self.shape: Dict[str, int] = {DATA_AXIS: dp, self.axis: n}
        self.data_rank, second_rank = device_mesh.get_coordinate()
        self.data_group = device_mesh.get_group(DATA_AXIS)
        second_group = device_mesh.get_group(self.axis)
        for axis in SECOND_AXES:
            mine = axis == self.axis
            setattr(self, f"{axis}_rank", second_rank if mine else 0)
            setattr(self, f"{axis}_group", second_group if mine else None)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, data_rank={self.data_rank}, "
                f"{self.axis}_rank={getattr(self, self.axis + '_rank')})")


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)) -> Mesh:
    """The (data, model) mesh over the joined process group:
    ``model_parallel`` contiguous ranks on the second axis (named
    ``axis_names[1]``), the rest on data (``core/mesh.py:23-44`` in JAX).
    ``n_devices`` (the world size when None) must be the world size: each
    rank is a process the launcher started, so there is none to leave
    out."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: launch with python -m "
                           "torch.distributed.run and call init_distributed first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"n_devices={n} but the process group has {world} ranks")
    if n % model_parallel != 0:
        raise ValueError(f"n_devices={n} not divisible by model_parallel={model_parallel}")
    from torch.distributed.device_mesh import init_device_mesh

    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    if tuple(axis_names)[0] != DATA_AXIS:
        raise ValueError(f"the first mesh axis is {DATA_AXIS!r}, got {axis_names}")
    grid = init_device_mesh(device.type, (n // model_parallel, model_parallel),
                            mesh_dim_names=tuple(axis_names))
    return Mesh(grid, device)


def data_sharding(mesh: Mesh, ndim: int = 1) -> PartitionSpec:
    """Dim 0 over the data axis, the rest replicated; a 0-d leaf
    replicates."""
    del mesh
    return P() if ndim <= 0 else P(DATA_AXIS, *([None] * (ndim - 1)))


def replicated_sharding(mesh: Mesh) -> PartitionSpec:
    del mesh
    return P()


class ShardedBatch(dict):
    """A batch as :func:`shard_batch` hands it to one rank: its rows of
    each leaf named in ``sharded`` (along ``batch_dim``), the others
    whole."""

    def __init__(self, leaves: Dict[str, torch.Tensor], sharded: frozenset, batch_dim: int):
        super().__init__(leaves)
        self.sharded = sharded
        self.batch_dim = batch_dim


def host_rows(mesh: Mesh, batch: Dict[str, Any], batch_dim: int = 0
              ) -> Tuple[Dict[str, torch.Tensor], frozenset]:
    """This data rank's rows of each leaf of a host batch, as CPU
    tensors, and the keys that were cut (see :func:`shard_batch`)."""
    n = mesh.shape[DATA_AXIS]
    out, sharded = {}, set()
    for key, value in batch.items():
        t = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
        if t.ndim > batch_dim and t.shape[batch_dim] % n == 0:
            size = t.shape[batch_dim] // n
            t = t.narrow(batch_dim, mesh.data_rank * size, size)
            sharded.add(key)
        out[key] = t
    return out, frozenset(sharded)


def shard_batch(mesh: Mesh, batch: Dict[str, Any], batch_dim: int = 0) -> ShardedBatch:
    """This data rank's rows of a host (global) batch, on the mesh's
    device: leaves whose ``batch_dim`` divides the data axis are cut into
    ``dp`` contiguous blocks; a leaf with fewer dims or whose dim does not
    divide (a final partial batch) is given whole to every rank."""
    rows, sharded = host_rows(mesh, batch, batch_dim)
    return ShardedBatch({k: t.to(mesh.device, non_blocking=True) for k, t in rows.items()},
                        sharded, batch_dim)


def local_batch_size(global_batch_size: int, mesh: Mesh) -> int:
    n_data = mesh.shape[DATA_AXIS]
    if global_batch_size % n_data != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by data-axis size {n_data}")
    return global_batch_size // n_data


# ---------------------------------------------------------------------------
# row draws
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RowShard:
    """This rank's share of the rows being computed: ``rank`` of ``size``
    data ranks over ``group``, each holding contiguous blocks of every one
    of ``groups`` leading row groups (``groups`` > 1: micro-batches
    flattened together, as the frozen-tower hoist runs them)."""

    group: Any
    rank: int
    size: int
    groups: int = 1


_ROWS: list = [None]


@contextlib.contextmanager
def row_shard_scope(shard: Optional[RowShard]) -> Iterator[None]:
    """Within the block, rows are sharded as ``shard`` says (None: every
    rank holds the whole batch): :func:`draw_rows` draws at the global
    shape and BatchNorm reduces its statistics over ``shard.group``."""
    prev = _ROWS[0]
    _ROWS[0] = shard
    try:
        yield
    finally:
        _ROWS[0] = prev


def current_row_shard() -> Optional[RowShard]:
    """The active :class:`RowShard`, or None outside a sharded step."""
    shard = _ROWS[0]
    return shard if shard is not None and shard.size > 1 else None


def draw_rows(draw: Callable[[Tuple[int, ...]], torch.Tensor], shape: Sequence[int],
              split: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """``draw(s)`` (a random tensor of shape ``s``) for a tensor of local
    ``shape`` whose dim 0 holds rows: under a sharded :class:`RowShard`
    it draws the global rows and keeps this rank's; ``split = (dim, rank,
    size)`` names a dim that ``size`` model ranks hold slices of, drawn
    whole and sliced the same way."""
    shape = tuple(shape)
    full, index = list(shape), [slice(None)] * len(shape)
    if split is not None and split[2] > 1:
        dim, r, size = split
        dim %= len(shape)
        full[dim] *= size
        index[dim] = slice(r * shape[dim], (r + 1) * shape[dim])
    rows = current_row_shard()
    if rows is None or not shape:
        return draw(tuple(full))[tuple(index)]
    per = shape[0] // rows.groups
    full = [rows.groups, per * rows.size] + full[1:]
    index = [slice(None), slice(rows.rank * per, (rows.rank + 1) * per)] + index[1:]
    return draw(tuple(full))[tuple(index)].reshape(shape)


# ---------------------------------------------------------------------------
# autograd collectives
# ---------------------------------------------------------------------------


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.rank, ctx.width = dist.get_rank(group), x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.width, ctx.width).contiguous(), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over ``group``
    (the input of a column-parallel product, whose ranks each see part of
    its gradient)."""
    return x if _size(group) == 1 else _Copy.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` forward (the partial products of a row-parallel
    layer); identity backward."""
    return x if _size(group) == 1 else _Reduce.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` forward and backward: a statistic of the whole
    batch that every rank's loss reads (synchronised BatchNorm)."""
    return x if _size(group) == 1 else _AllReduceSum.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' slices of ``group`` concatenated along ``dim`` forward
    (vocab-parallel logits); the backward keeps this rank's slice."""
    return x if _size(group) == 1 else _Gather.apply(x, group, dim % x.ndim)


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Sum ``x`` over ``group`` and keep this rank's slice along ``dim``."""
    n, r = _size(group), dist.get_rank(group)
    width = x.shape[dim] // n
    if dist.get_backend(group) == "nccl":
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((width,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim).contiguous()
    return _all_reduce(x, group).narrow(dim, r * width, width).contiguous()


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


class _GatherReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatterGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        width = x.shape[dim] // _size(group)
        return x.narrow(dim, dist.get_rank(group) * width, width).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SequenceSplit:
    """Activations split along ``dim`` (T) over the ``size`` ranks of the
    model ``group``: this rank holds the contiguous slice ``rank``. The
    autograd collectives between the two forms:

    * :meth:`scatter` keeps this rank's slice of a whole tensor (backward:
      all-gather), :meth:`gather` the reverse for a consumer that every
      rank runs whole (backward: keep the slice);
    * :meth:`gather_for_product` all-gathers the input of column-parallel
      products, whose input gradient is then summed and split in one
      reduce-scatter; :meth:`reduce_scatter` sums a row-parallel layer's
      partial products and keeps the slice (backward: all-gather)."""

    group: Any
    rank: int
    size: int
    dim: int = 1

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        return _Scatter.apply(x, self.group, self.dim)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return gather_from_group(x, self.group, self.dim)

    def gather_for_product(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherReduceScatter.apply(x, self.group, self.dim)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceScatterGather.apply(x, self.group, self.dim)

    def draw_split(self) -> Tuple[int, int, int]:
        """The ``split`` of :func:`draw_rows` for a tensor in the split form."""
        return (self.dim, self.rank, self.size)


_ACTIVATION_MESH: list = [None]
_SEQUENCE: list = [None]


@contextlib.contextmanager
def activation_sharding_scope(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Within the block, :func:`constrain_activation` splits activations over
    ``mesh``'s model axis (None: it splits nothing). The train and eval
    steps enter it themselves (``train/loop.py``), so a caller never
    needs to; the scope is a module global and not thread-safe."""
    prev = _ACTIVATION_MESH[0]
    _ACTIVATION_MESH[0] = mesh
    try:
        yield mesh
    finally:
        _ACTIVATION_MESH[0] = prev


def constrain_activation(x: torch.Tensor, *spec
                         ) -> Tuple[torch.Tensor, Optional[SequenceSplit]]:
    """JAX's ``constrain_activation`` (``with_sharding_constraint(x,
    P(*spec))`` under the active scope) on the whole activation ``x``: this
    model rank's slice of the dim ``spec`` names :data:`MODEL_AXIS`, and
    the :class:`SequenceSplit` that took it. ``(x, None)`` outside the
    scope, for a model axis of 1, or when the axis does not divide the
    dim: the activation stays whole, as JAX drops such an axis (the data
    axis names rows this rank already holds)."""
    mesh = _ACTIVATION_MESH[0]
    if mesh is None or MODEL_AXIS not in spec:
        return x, None
    dim, size = spec.index(MODEL_AXIS), mesh.shape.get(MODEL_AXIS, 1)
    if size <= 1 or x.shape[dim] % size != 0:
        return x, None
    split = SequenceSplit(mesh.model_group, mesh.model_rank, size, dim)
    return split.scatter(x), split


@contextlib.contextmanager
def sequence_split_scope(split: Optional[SequenceSplit]) -> Iterator[None]:
    """Within the block the activations entering the layers are in
    ``split``'s form (None: whole); a transformer block enters it around
    its own forward, so a remat recompute runs under it too."""
    prev = _SEQUENCE[0]
    _SEQUENCE[0] = split
    try:
        yield
    finally:
        _SEQUENCE[0] = prev


def current_sequence_split() -> Optional[SequenceSplit]:
    """The split of :func:`sequence_split_scope`, or None."""
    return _SEQUENCE[0]
