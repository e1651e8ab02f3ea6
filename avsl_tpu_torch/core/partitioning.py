"""Parameter partitioning over the (data, model), (data, expert) or
(data, stage) mesh: the rule table, tensor and expert parallelism, ZeRO-1
and FSDP, and the layout of a pipeline's stage rows.

Port of ``avsl_tpu/core/partitioning.py``. ``DEFAULT_RULES``, ``spec_for``,
``ZERO1_MIN_ELEMS`` and ``_add_data_axis`` are JAX's pure functions over
paths, shapes and ``mesh.shape``, with the same divisibility fallbacks.
The rules match flax paths and flax layouts, so a port parameter is
matched through the flax path its state-dict key maps to
(``core/tree.py::rule_path``) and its spec is read through the transpose
(``core/tree.py::flax_dims``): flax's column-parallel ``P(None, "model")``
on a ``[in, out]`` kernel is dim 0 of the torch ``[out, in]`` weight,
row-parallel ``P("model", None)`` is dim 1. :func:`torch_spec` gives a
parameter's spec in its own (torch) layout.

:func:`shard_state` puts a train state on the mesh, as JAX's
``device_put`` of the state into ``state_shardings`` does:

* tensor parallelism, by hand: a column-parallel ``CastLinear`` keeps its
  rows of the weight and bias, a row-parallel one its columns (its bias
  whole, added after the sum), and ``MultiHeadAttention`` then runs on
  ``n_heads / mp`` local heads; a vocab-sharded token embedding keeps its
  rows (the vocab-parallel lookup and tied logits of
  ``models/whisper.py`` and of the AV-HuBERT decoder); the classifier
  heads ``ctc_head`` and ``final_proj`` run column-parallel and gather
  their output, and the pretraining codebook ``label_embs_concat`` keeps
  its rows of the classes (``models/pretrain.py``); an MoE FFN keeps its
  slice of the hidden dim (``models/moe.py``);
* expert parallelism on an expert axis: an MoE FFN keeps its ``E / ep``
  experts of ``w_in``, ``b_in``, ``w_out`` and ``b_out``;
* ``zero1``: the Adam moments of each trained tensor of at least
  ``ZERO1_MIN_ELEMS`` elements keep this data rank's slice along the dim
  ``_add_data_axis`` picks (``train/optim.py`` updates that slice and
  all-gathers the parameter);
* ``fsdp``: FSDP2's ``fully_shard`` over the ``data`` sub-mesh, on every
  transformer block of the Whisper encoder and decoder and of the video
  tower, on the root's children that hold parameters, then on the root. FSDP2 splits every parameter along dim 0,
  small ones too, where JAX keeps leaves under ``ZERO1_MIN_ELEMS``
  whole. On a data axis of 1 it is JAX's no-op (a data axis of size 1
  splits nothing): no ``fully_shard``, so the step is the no-mesh one.
  FSDP2 there would only add copies, and its hooks on each unit's inputs
  sum a tensor's gradient from several units (the projected video that
  every decoder block reads) in another order than one device does.
  Under LoRA (a ``models/lora.py::LoraModel`` state) the base model is a
  constant whole on every rank, as JAX's closure holds it, and the
  adapters, which no rule names, take ZeRO-1's split of their moments.

The resulting :class:`Layout` maps each tensor between its local form and
the full (logical) one, which checkpoints hold. The tensor- and
expert-parallel splits are both over the mesh's second axis (the mesh has
one or the other). On a stage axis the same layout holds a pipeline's
split: every stacked block tensor keeps its stage's rows of dim 0
(``train/pp.py::shard_pp_state`` builds it; :func:`shard_state` refuses
such a mesh).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from avsl_tpu_torch.core.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    STAGE_AXIS,
    Mesh,
    PartitionSpec,
)
from avsl_tpu_torch.core.tree import flax_dims, rule_path

P = PartitionSpec

# (path regex, spec) - first match wins; specs name dims of the flax layout
DEFAULT_RULES: List[Tuple[str, PartitionSpec]] = [
    (r"mlp/w_in$", P(EXPERT_AXIS, None, MODEL_AXIS)),
    (r"mlp/b_in$", P(EXPERT_AXIS, MODEL_AXIS)),
    (r"mlp/w_out$", P(EXPERT_AXIS, MODEL_AXIS, None)),
    (r"mlp/b_out$", P(EXPERT_AXIS, None)),
    (r"mlp/router$", P()),
    (r"(mlp|x_mlp)/fc1/kernel$", P(None, MODEL_AXIS)),
    (r"(mlp|x_mlp)/fc1/bias$", P(MODEL_AXIS)),
    (r"(mlp|x_mlp)/fc2/kernel$", P(MODEL_AXIS, None)),
    (r"(q_proj|k_proj|v_proj)/kernel$", P(None, MODEL_AXIS)),
    (r"(q_proj|k_proj|v_proj)/bias$", P(MODEL_AXIS)),
    (r"out_proj/kernel$", P(MODEL_AXIS, None)),
    (r"token_embedding/embedding$", P(MODEL_AXIS, None)),
    (r"embed_tokens/embedding$", P(MODEL_AXIS, None)),
    (r"ctc_head/kernel$", P(None, MODEL_AXIS)),
    (r"ctc_head/bias$", P(MODEL_AXIS)),
    (r"final_proj/kernel$", P(None, MODEL_AXIS)),
    (r"final_proj/bias$", P(MODEL_AXIS)),
    (r"label_embs$", P(MODEL_AXIS, None)),
]


def spec_for(path: str, shape: Tuple[int, ...], mesh,
             rules: Sequence[Tuple[str, PartitionSpec]] = DEFAULT_RULES) -> PartitionSpec:
    """PartitionSpec of one leaf (flax path and layout): the first rule
    that matches, each of its axes kept only where the mesh has it above
    size 1 and it divides the dim; a rule whose axes all drop, or no rule,
    replicates."""
    for pat, spec in rules:
        if re.search(pat, path):
            if len(spec) > len(shape):
                return P()
            fixed = []
            for d, axis in enumerate(spec):
                n = mesh.shape.get(axis, 1) if axis is not None else 1
                fixed.append(axis if n > 1 and shape[d] % n == 0 else None)
            return P(*fixed) if any(a is not None for a in fixed) else P()
    return P()


# leaves smaller than this stay replicated under zero1/fsdp
ZERO1_MIN_ELEMS = 65536


def _add_data_axis(spec: PartitionSpec, shape: Tuple[int, ...], mesh) -> PartitionSpec:
    """ZeRO refinement of a TP spec: the data axis on the first free dim
    it divides; no such dim leaves the spec as it is."""
    dp = mesh.shape.get(DATA_AXIS, 1)
    if dp <= 1:
        return spec
    fixed = list(spec) + [None] * (len(shape) - len(spec))
    for d, axis in enumerate(fixed):
        if axis is None and shape[d] % dp == 0:
            fixed[d] = DATA_AXIS
            return P(*fixed)
    return spec


def torch_spec(key: str, shape: Sequence[int], mesh,
               rules: Sequence[Tuple[str, PartitionSpec]] = DEFAULT_RULES,
               data_axis: bool = False) -> PartitionSpec:
    """The spec of the port's tensor ``key`` in its own layout: the flax
    spec of its flax path and shape (with ``_add_data_axis`` when
    ``data_axis`` and it has ``ZERO1_MIN_ELEMS`` elements or more), each
    axis moved to the torch dim that holds its flax dim. Replicated is
    ``P()``."""
    dims = flax_dims(key, len(shape))
    flax_shape = [0] * len(shape)
    for j, i in enumerate(dims):
        flax_shape[i] = shape[j]
    spec = spec_for(rule_path(key), tuple(flax_shape), mesh, rules)
    numel = 1
    for s in shape:
        numel *= s
    if data_axis and numel >= ZERO1_MIN_ELEMS:
        spec = _add_data_axis(spec, tuple(flax_shape), mesh)
    if spec == P():
        return P()
    flax_spec = list(spec) + [None] * (len(shape) - len(spec))
    return P(*(flax_spec[i] for i in dims))


def state_shardings(state, mesh, rules: Sequence[Tuple[str, PartitionSpec]] = DEFAULT_RULES,
                    zero1: bool = False, fsdp: bool = False) -> Dict[str, Dict[str, PartitionSpec]]:
    """JAX's layout of a train state in the port's terms: ``{"params":
    {name: spec}, "opt_state": {name: spec}}`` for the model's parameters
    and the Adam moments of the trained ones (one spec for ``mu`` and
    ``nu``), each in the torch layout. ``zero1`` adds the data axis to the
    moments of large leaves, ``fsdp`` to the parameters too."""
    params = dict(state.model.named_parameters())
    trained = [] if state.optimizer is None else state.optimizer.names
    return {
        "params": {n: torch_spec(n, full_shape(state, n, p), mesh, rules, data_axis=fsdp)
                   for n, p in params.items()},
        "opt_state": {n: torch_spec(n, full_shape(state, n, params[n]), mesh, rules,
                                    data_axis=zero1 or fsdp) for n in trained},
    }


def full_shape(state, name: str, p: torch.Tensor) -> Tuple[int, ...]:
    """The logical shape of parameter ``name`` of ``state``, sharded or
    not."""
    layout = getattr(state, "layout", None)
    return tuple(p.shape) if layout is None else layout.shapes[name]


def describe_shardings(model: nn.Module, mesh,
                       rules: Sequence[Tuple[str, PartitionSpec]] = DEFAULT_RULES):
    """(name, shape, spec) of every parameter the rules shard (torch
    layout)."""
    out = []
    for name, p in model.named_parameters():
        spec = torch_spec(name, tuple(p.shape), mesh, rules)
        if spec != P():
            out.append((name, tuple(p.shape), spec))
    return out


# ---------------------------------------------------------------------------
# the layout of a state on the mesh
# ---------------------------------------------------------------------------


def _chunk(full: torch.Tensor, rank: int, n: int) -> torch.Tensor:
    """FSDP2's dim-0 shard of rank ``rank`` of ``n`` (``torch.chunk``)."""
    parts = torch.chunk(full, n, dim=0)
    return parts[rank] if rank < len(parts) else full[:0]


def _gather_chunks(local: torch.Tensor, rows: int, group, n: int) -> torch.Tensor:
    """The inverse of :func:`_chunk` over ``group``: every rank's chunk,
    padded to one size for the collective, concatenated and trimmed to
    ``rows``."""
    size = -(-rows // n)
    padded = local.new_zeros((size,) + tuple(local.shape[1:]))
    padded[:local.shape[0]] = local
    parts = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(parts, padded.contiguous(), group=group)
    return torch.cat(parts, 0)[:rows]


def _gather_dim(local: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts, dim)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """The local shard of a DTensor (FSDP's parameters), else ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t


def second_axis(mesh) -> str:
    """The name of ``mesh``'s axis besides data: ``"model"``, ``"expert"``
    or ``"stage"``."""
    return next((a for a in (EXPERT_AXIS, STAGE_AXIS) if a in mesh.shape), MODEL_AXIS)


class Layout:
    """How a train state sits on ``mesh``: the dim each parameter split
    over the mesh's second axis is split along (``tp``: tensor-parallel on
    a model axis, expert-parallel on an expert axis, a stage's rows of dim
    0 on a stage axis), the dim of each
    trained tensor's Adam moments split over the data axis under ZeRO-1
    (``zero``), whether FSDP shards every parameter along dim 0 over the
    data axis (``fsdp``), and each parameter's logical shape
    (``shapes``)."""

    def __init__(self, mesh: Mesh, tp: Dict[str, int], zero: Dict[str, int], fsdp: bool,
                 shapes: Dict[str, Tuple[int, ...]]):
        self.mesh, self.tp, self.zero, self.fsdp, self.shapes = mesh, tp, zero, fsdp, shapes
        self.axis = second_axis(mesh)
        self.dp, self.mp = mesh.shape[DATA_AXIS], mesh.shape[self.axis]
        self.split_rank = getattr(mesh, f"{self.axis}_rank")
        self.split_group = getattr(mesh, f"{self.axis}_group", None)

    # --- full <-> local ---------------------------------------------------

    def local(self, name: str, full: torch.Tensor, moment: bool = False) -> torch.Tensor:
        """This rank's part of the logical tensor ``full`` of parameter
        ``name`` (of its Adam moments with ``moment``)."""
        t = full
        if name in self.tp:
            d = self.tp[name]
            size = t.shape[d] // self.mp
            t = t.narrow(d, self.split_rank * size, size)
        if self.fsdp:
            t = _chunk(t, self.mesh.data_rank, self.dp)
        elif moment and name in self.zero:
            d = self.zero[name]
            size = t.shape[d] // self.dp
            t = t.narrow(d, self.mesh.data_rank * size, size)
        return t

    def full(self, name: str, local: torch.Tensor, moment: bool = False) -> torch.Tensor:
        """The logical tensor of parameter ``name`` (of its moments with
        ``moment``) from every rank's part; a collective over the mesh."""
        t = local_tensor(local).detach()
        if self.fsdp:
            rows = self.shapes[name][0] // (self.mp if self.tp.get(name) == 0 else 1)
            t = _gather_chunks(t, rows, self.mesh.data_group, self.dp)
        elif moment and name in self.zero:
            t = _gather_dim(t, self.zero[name], self.mesh.data_group, self.dp)
        if name in self.tp:
            t = _gather_dim(t, self.tp[name], self.split_group, self.mp)
        return t

    def norm_group(self, name: str):
        """The groups over which the local gradient of ``name`` is a part
        of the whole: ``(data group or None, second-axis group or None)``."""
        data = self.mesh.data_group if self.fsdp and self.dp > 1 else None
        split = self.split_group if name in self.tp and self.mp > 1 else None
        return data, split

    # --- whole state dicts ----------------------------------------------

    def full_model_state(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """The model's state dict with every parameter whole, on the CPU."""
        params = {n for n, _ in model.named_parameters()}
        return {k: (self.full(k, v) if k in params else v.detach()).cpu()
                for k, v in model.state_dict().items()}

    def load_model_state(self, model: nn.Module, state: Dict[str, torch.Tensor]) -> None:
        """Copy a whole state dict into the model's local parts."""
        own = model.state_dict(keep_vars=True)
        missing = sorted(set(own) - set(state))
        unexpected = sorted(set(state) - set(own))
        if missing or unexpected:
            raise KeyError(f"state dict mismatch: missing {missing[:5]}, "
                           f"unexpected {unexpected[:5]}")
        params = {n for n, _ in model.named_parameters()}
        with torch.no_grad():
            for k, dst in own.items():
                src = state[k]
                if k in params:
                    src = self.local(k, src)
                local_tensor(dst).copy_(src)


def fsdp_applies(mesh: Mesh, fsdp: bool) -> bool:
    """Whether ``fsdp`` shards anything on ``mesh``: only on a data axis
    above 1."""
    return bool(fsdp) and mesh.shape[DATA_AXIS] > 1


def _tp_dim(spec: PartitionSpec, axis: str) -> Optional[int]:
    return spec.index(axis) if axis in spec else None


def _fsdp_units(model: nn.Module) -> List[nn.Module]:
    """The modules FSDP wraps before the root, innermost first: every
    transformer block of the Whisper encoder and decoder and of the video
    tower, then each child of the root that holds parameters, so the root
    holds none of its own and a method that runs a part of the model
    (``encode_towers``, ``project_and_decode``) gathers what that part
    reads."""
    units = []
    for name, module in model.named_modules():
        if re.search(r"(^|\.)(blocks|layers)$", name) and isinstance(module, nn.ModuleList):
            units.extend(module)
    units.extend(child for child in model.children()
                 if any(True for _ in child.parameters()))
    return units


def _set_parallel(model: nn.Module, tp: Dict[str, int], mesh: Mesh) -> set:
    """Tell each module that holds a split parameter of ``tp`` how it runs
    on ``mesh``'s second axis; returns the names of the parameters so
    handled."""
    from avsl_tpu_torch.models.avhubert import AVHuBERTDecoder
    from avsl_tpu_torch.models.layers import CastLinear
    from avsl_tpu_torch.models.moe import MoEFFN
    from avsl_tpu_torch.models.pretrain import AVHuBERTForPretraining
    from avsl_tpu_torch.models.whisper import WhisperTextDecoder

    axis = second_axis(mesh)
    group, rank = getattr(mesh, f"{axis}_group", None), getattr(mesh, f"{axis}_rank")
    size = mesh.shape[axis]
    handled = set()
    for mname, module in model.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(module, CastLinear) and prefix + "weight" in tp:
            # the classifier heads' loss reads every class: their output gathers
            head = mname.rsplit(".", 1)[-1] in ("ctc_head", "final_proj")
            mode = ("col_gather" if head else "col") if tp[prefix + "weight"] == 0 else "row"
            module.set_tensor_parallel(mode, group, rank, size)
            handled.update({prefix + "weight", prefix + "bias"})
        elif isinstance(module, MoEFFN) and prefix + "w_in" in tp:
            module.set_parallel(axis, group, rank, size)
            handled.update(prefix + n for n in ("w_in", "b_in", "w_out", "b_out"))
        elif isinstance(module, WhisperTextDecoder) and prefix + "token_embedding.weight" in tp:
            module.set_vocab_parallel(group, rank, size)
            handled.add(prefix + "token_embedding.weight")
        elif isinstance(module, AVHuBERTDecoder) and prefix + "embed_tokens.weight" in tp:
            module.set_vocab_parallel(group, rank, size)
            handled.add(prefix + "embed_tokens.weight")
        if isinstance(module, AVHuBERTForPretraining) and prefix + "label_embs_concat" in tp:
            module.set_class_parallel(group, rank, size)
            handled.add(prefix + "label_embs_concat")
    return handled


def shard_state(state, mesh: Mesh, rules: Sequence[Tuple[str, PartitionSpec]] = DEFAULT_RULES,
                zero1: bool = False, fsdp: bool = False):
    """Put ``state`` (a ``train.loop.TrainState`` whose model and
    optimizer are whole, on ``mesh.device``) on ``mesh`` in place: tensor
    or expert parallelism from the rules, then ZeRO-1 or FSDP (a LoRA
    state's adapters take ZeRO-1's split under either); ``state.layout``
    is set and the optimizer is rebound to the local tensors. Returns
    ``state``."""
    from avsl_tpu_torch.models.lora import LoraModel

    if getattr(state, "layout", None) is not None:
        raise ValueError("the state is already on a mesh")
    if STAGE_AXIS in mesh.shape:
        raise ValueError("a state goes on a stage mesh through train.pp.shard_pp_state")
    model, opt = state.model, state.optimizer
    if isinstance(model, LoraModel):  # JAX's frozen base is a constant, whole everywhere
        zero1, fsdp = zero1 or fsdp, False
    axis = second_axis(mesh)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    tp: Dict[str, int] = {}
    for name, p in model.named_parameters():
        d = _tp_dim(torch_spec(name, p.shape, mesh, rules), axis)
        if d is not None:
            tp[name] = d
    handled = _set_parallel(model, tp, mesh)
    if set(tp) - handled:
        raise ValueError(f"the rules split {sorted(set(tp) - handled)[:3]} over {axis!r}, "
                         "which no module of the model runs split")
    mp, rank = mesh.shape[axis], getattr(mesh, f"{axis}_rank")
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            if name in tp:
                d = tp[name]
                size = p.shape[d] // mp
                p.data = p.data.narrow(d, rank * size, size).clone()
    zero: Dict[str, int] = {}
    if zero1 and not fsdp and opt is not None:
        for name in opt.names:
            spec = torch_spec(name, shapes[name], mesh, rules, data_axis=True)
            if DATA_AXIS in spec:
                zero[name] = spec.index(DATA_AXIS)
    trained = set() if opt is None else set(opt.names)
    fsdp = fsdp_applies(mesh, fsdp)
    if fsdp:
        from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

        for name, p in model.named_parameters():
            p.requires_grad_(name in trained)
        data_mesh = mesh.device_mesh[DATA_AXIS]
        for unit in _fsdp_units(model):
            fully_shard(unit, mesh=data_mesh)
        fully_shard(model, mesh=data_mesh)
        for method in ("encode_towers", "project_and_decode"):
            if hasattr(model, method):
                register_fsdp_forward_method(model, method)
    layout = Layout(mesh, tp, zero, fsdp, shapes)
    if opt is not None:
        opt.bind(dict(model.named_parameters()), layout)
    state.layout = layout
    return state
