"""Mixture-of-experts FFN of the AV-HuBERT encoder, on one device or on a
mesh.

Port of ``avsl_tpu/models/moe.py``: the GShard/Switch dense dispatch.
Routing (top-k gates, capacity, the slot of each token in its expert) is
computed with static shapes, and dispatch and combine are products
against ``[tokens, experts, capacity]`` one-hot tensors, so the experts
run as one batched ``[E, C, D] x [E, D, F]`` product a projection. These
are plain products, as in JAX (no Pallas kernel there): ``torch.einsum``.

The Switch balance loss (``n_experts * sum_e f_e * P_e``, 1 at perfect
balance) is sown as ``"moe_aux"`` (:mod:`avsl_tpu_torch.models.intermediates`);
:func:`moe_aux_loss` is the mean over every MoE layer of a forward.

Padding: ``valid`` ([B, T], 1 = a real token; the encoder derives it from
its key lengths) keeps pad tokens from claiming capacity and from the
balance statistics; their FFN delta is zero. Without ``valid`` every
position routes.

On a mesh JAX's program is one over the global batch, and so is this
layer's result (``core/mesh.py`` names the groups):

* inside a step whose rows are split over data ranks
  (:func:`~avsl_tpu_torch.core.mesh.current_row_shard`) the routing is the
  one-device routing: ``C`` counts the global tokens, each round's slots
  queue behind the claims of the earlier ranks' tokens (the global token
  order is rank-major; micro-batches flattened by the frozen-tower hoist
  keep theirs), and the balance loss's three sums are summed over the
  data group, forward and backward (``all_reduce_sum``: every rank's loss
  reads them, and the step averages the gradients);
* on an expert axis (:func:`make_ep_mesh`; ``core/partitioning.py`` calls
  :meth:`MoEFFN.set_parallel`) each rank holds ``E / ep`` experts; a data
  rank fills its own tokens' slots of them, the ``[E / ep, C, D]`` input
  is summed over the data group (the slots are disjoint), every rank of
  the column runs its experts on all ``C`` slots, combines its tokens from
  them, and the partial outputs are summed over the expert group;
* on a model axis each rank holds its slice of the hidden ``F`` (``w_in``
  and ``b_in`` by column, ``w_out`` by row; ``b_out`` whole): the experts
  run as a column- then row-parallel pair whose partial outputs are
  summed over the model group before ``b_out``.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from avsl_tpu_torch.core.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    RowShard,
    all_reduce_sum,
    copy_to_group,
    current_row_shard,
    make_mesh,
    reduce_from_group,
)
from avsl_tpu_torch.models.intermediates import sow
from avsl_tpu_torch.models.layers import cast_param

__all__ = ["EXPERT_AXIS", "MoEFFN", "make_ep_mesh", "moe_aux_loss"]

# flax's lecun_normal: a normal truncated at 2 standard deviations, whose
# std is rescaled by this so that the truncated law has variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def make_ep_mesh(n_devices: Optional[int] = None, experts_parallel: int = 1,
                 devices: Optional[Sequence] = None):
    """The (data, expert) mesh: ``experts_parallel`` contiguous ranks on
    the axis named ``"expert"``, the rest on data (JAX's ``make_ep_mesh``).
    The ranks are the launcher's processes, so ``devices`` must be None."""
    if devices is not None:
        raise ValueError("the mesh's ranks are the launcher's processes: pass no devices")
    return make_mesh(n_devices, model_parallel=experts_parallel,
                     axis_names=(DATA_AXIS, EXPERT_AXIS))


def _earlier_claims(onehot: torch.Tensor, rows: RowShard) -> Tuple[torch.Tensor, torch.Tensor]:
    """For a round's slot claims ``onehot`` [N, E] of this data rank's
    tokens: per token, the claims of the global tokens before it that are
    not this rank's own earlier tokens ([N, E], to add to the local
    ``cumsum``), and the round's claims over every rank ([E]). The global
    order runs over the ``groups`` row blocks, and within each over the
    ranks in turn."""
    g, e = rows.groups, onehot.shape[1]
    local = onehot.reshape(g, -1, e).sum(dim=1)  # [G, E]
    parts = [torch.empty_like(local) for _ in range(rows.size)]
    dist.all_gather(parts, local.contiguous(), group=rows.group)
    everyone = torch.stack(parts, dim=1)  # [G, dp, E], in the global order
    flat = everyone.reshape(-1, e)
    before = (flat.cumsum(dim=0) - flat).reshape(g, rows.size, e)[:, rows.rank]
    offset = before - (local.cumsum(dim=0) - local)  # minus the local cumsum's own part
    return offset.repeat_interleave(onehot.shape[0] // g, dim=0), everyone.sum(dim=(0, 1))


class Routing(NamedTuple):
    """:meth:`MoEFFN.route`'s result."""

    dispatch: torch.Tensor
    combine: torch.Tensor
    probs: torch.Tensor
    top1: torch.Tensor
    valid: torch.Tensor


class MoEFFN(nn.Module):
    """Drop-in replacement for the dense MLP: each token goes to its
    ``top_k`` experts. Each expert takes at most ``C = max(1,
    ceil(capacity_factor * top_k * B * T / n_experts))`` tokens (pad tokens
    count in ``B * T``, the global batch's on a data axis); a token past
    its expert's capacity gets a zero delta from it.

    Parameters (``param_dtype``): ``router`` [D, E] from N(0, 0.02),
    ``w_in`` [E, D, F] and ``w_out`` [E, F, D] lecun-normal (flax's fan-in
    over the expert and input axes), ``b_in`` [E, F] and ``b_out`` [E, D]
    zero. Routing runs in fp32; the dispatch, the expert products and the
    biases in ``dtype`` with the parameters cast at use; the expert
    activation is the tanh-approximated GELU (flax's ``nn.gelu``); the
    output comes back in the input's dtype."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, top_k: int = 2,
                 capacity_factor: float = 1.25, dtype=torch.bfloat16, param_dtype=None,
                 device=None):
        super().__init__()
        self.d_model, self.d_ff, self.n_experts = d_model, d_ff, n_experts
        self.top_k, self.capacity_factor, self.dtype = top_k, capacity_factor, dtype
        kw = dict(device=device, dtype=param_dtype or dtype)
        self.router = nn.Parameter(torch.empty(d_model, n_experts, **kw))
        self.w_in = nn.Parameter(torch.empty(n_experts, d_model, d_ff, **kw))
        self.b_in = nn.Parameter(torch.empty(n_experts, d_ff, **kw))
        self.w_out = nn.Parameter(torch.empty(n_experts, d_ff, d_model, **kw))
        self.b_out = nn.Parameter(torch.empty(n_experts, d_model, **kw))
        self.parallel: Optional[Tuple[str, Any, int, int]] = None

    @torch.no_grad()
    def init_from(self, generator: torch.Generator) -> None:
        """flax's initialisation of the five parameters (see the class)."""
        self.router.normal_(0.0, 0.02, generator=generator)
        for w in (self.w_in, self.w_out):
            std = 1.0 / math.sqrt(w.shape[0] * w.shape[1]) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        self.b_in.zero_()
        self.b_out.zero_()

    def set_parallel(self, axis: str, group, rank: int, size: int) -> None:
        """Run as part ``rank`` of ``size`` over ``group`` on the mesh axis
        ``axis``: ``"expert"`` (this rank's ``E / size`` experts) or
        ``"model"`` (its slice of the hidden ``F``);
        ``core/partitioning.py::shard_state`` cuts the tensors."""
        if axis not in (EXPERT_AXIS, MODEL_AXIS):
            raise ValueError(f"MoE parallel axis {axis!r}: {EXPERT_AXIS!r} or {MODEL_AXIS!r}")
        self.parallel = (axis, group, rank, size)

    def capacity(self, n_tokens: int) -> int:
        k = min(self.top_k, self.n_experts)
        return max(1, int(math.ceil(self.capacity_factor * k * n_tokens / self.n_experts)))

    def route(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None) -> Routing:
        """The routing of ``x``'s [B, T] tokens (one device's over the
        global batch; see the module docstring): the fp32 ``dispatch`` and
        ``combine`` [N, E, C] tensors, the router ``probs`` [N, E], each
        token's ``top1`` expert and its ``valid`` weight."""
        b, t, d = x.shape
        e, k, n = self.n_experts, min(self.top_k, self.n_experts), b * t
        rows = current_row_shard()
        c = self.capacity(n * (1 if rows is None else rows.size))
        v = (torch.ones(n, device=x.device) if valid is None
             else valid.reshape(n).to(x.device, torch.float32))
        probs = torch.softmax(x.reshape(n, d).float() @ self.router.float(), dim=-1)  # [N, E]
        # each expert rank combines from its own experts only, so the gates'
        # gradient, like the dispatched tokens', is a part summed over them
        gate_probs = probs
        if self.parallel is not None and self.parallel[0] == EXPERT_AXIS:
            gate_probs = copy_to_group(probs, self.parallel[1])

        # iterative top-k (GShard priority): every token's k-th choice
        # queues behind all the (k-1)-th choices, so `count` carries the
        # occupancy of the earlier rounds into the slot positions
        masked, count = probs, torch.zeros(e, device=x.device)
        dispatch = torch.zeros(n, e, c, device=x.device)
        gates, top1 = [], None
        for _ in range(k):
            idx = masked.argmax(dim=-1)  # ties go to the first expert
            top1 = idx if top1 is None else top1
            gate = gate_probs.gather(1, idx[:, None])[:, 0]
            raw = F.one_hot(idx, e).float()  # [N, E]
            onehot = raw * v[:, None]  # pad tokens claim no slot
            pos = onehot.cumsum(dim=0) - 1.0 + count
            if rows is None:
                claimed = onehot.sum(dim=0)
            else:  # behind the earlier ranks' tokens, as one device queues them
                before, claimed = _earlier_claims(onehot, rows)
                pos = pos + before
            pos_k = pos.gather(1, idx[:, None])[:, 0]
            keep = (pos_k < c).float()
            slot = F.one_hot(pos_k.clamp(0, c - 1).long(), c).float()
            disp_k = onehot[:, :, None] * slot[:, None, :] * keep[:, None, None]
            dispatch = dispatch + disp_k
            gates.append((gate, disp_k))
            count = count + claimed
            masked = masked * (1.0 - raw)

        # K > 1: gates normalised over the top k (GShard, Mixtral); K = 1:
        # the raw router probability (Switch), which keeps the router on
        # the main gradient path
        total = sum(g for g, _ in gates)
        denom = total.clamp_min(1e-9) if k > 1 else 1.0
        combine = sum((g / denom)[:, None, None] * dk for g, dk in gates)  # [N, E, C]
        return Routing(dispatch, combine, probs, top1, v)

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, d = x.shape
        e, n = self.n_experts, b * t
        rows = current_row_shard()
        axis, group = (None, None) if self.parallel is None else self.parallel[:2]
        r = self.route(x, valid)
        dispatch, combine, xt = r.dispatch, r.combine, x.reshape(n, d)

        cd = self.dtype
        if axis == EXPERT_AXIS:  # this rank's experts
            lo, width = self.parallel[2] * self.w_in.shape[0], self.w_in.shape[0]
            dispatch, combine = dispatch[:, lo:lo + width], combine[:, lo:lo + width]
            xt = copy_to_group(xt, group)
        expert_in = torch.einsum("nec,nd->ecd", dispatch.to(cd), xt.to(cd))
        if rows is not None:  # every data rank's slots (disjoint)
            expert_in = reduce_from_group(expert_in, rows.group)
        if axis == MODEL_AXIS:
            expert_in = copy_to_group(expert_in, group)
        h = (torch.einsum("ecd,edf->ecf", expert_in, cast_param(self.w_in, cd))
             + cast_param(self.b_in, cd)[:, None, :])
        h = F.gelu(h, approximate="tanh")
        out = torch.einsum("ecf,efd->ecd", h, cast_param(self.w_out, cd))
        if axis == MODEL_AXIS:
            out = reduce_from_group(out, group)
        out = out + cast_param(self.b_out, cd)[:, None, :]
        y = torch.einsum("nec,ecd->nd", combine.to(cd), out)
        if axis == EXPERT_AXIS:
            y = reduce_from_group(y, group)

        # Switch balance loss over the real tokens: E * sum_e (top-1
        # fraction_e * mean router probability_e)
        v = r.valid
        sums = torch.cat([(r.probs * v[:, None]).sum(dim=0),
                          (F.one_hot(r.top1, e).float() * v[:, None]).sum(dim=0), v.sum()[None]])
        if rows is not None:
            sums = all_reduce_sum(sums, rows.group)
        n_valid = sums[-1].clamp_min(1.0)
        p_mean, frac = sums[:e] / n_valid, sums[e:2 * e] / n_valid
        sow("moe_aux", e * (frac * p_mean).sum())
        return y.reshape(b, t, d).to(x.dtype)


def moe_aux_loss(intermediates: Mapping) -> torch.Tensor:
    """The mean of every ``"moe_aux"`` a forward sowed (one per MoE layer,
    a layer LayerDrop dropped included); 0 when there is none."""
    leaves = list(intermediates.get("moe_aux", ()))
    if not leaves:
        return torch.zeros(())
    return torch.stack(leaves).mean()
