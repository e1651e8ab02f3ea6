"""Mixture-of-experts FFN of the AV-HuBERT encoder, on one device.

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

Expert parallelism (``make_ep_mesh``, ``--experts_parallel``) and an MoE
tower on a data axis above 1 are ROADMAP.md item 12e's and raise.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from avsl_tpu_torch.models.intermediates import sow
from avsl_tpu_torch.models.layers import cast_param

EXPERT_AXIS = "expert"

__all__ = ["EXPERT_AXIS", "MoEFFN", "make_ep_mesh", "moe_aux_loss"]

# flax's lecun_normal: a normal truncated at 2 standard deviations, whose
# std is rescaled by this so that the truncated law has variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def make_ep_mesh(n_devices: Optional[int] = None, experts_parallel: int = 1,
                 devices: Optional[Sequence] = None):
    """The (data, expert) mesh of the JAX package: not ported yet."""
    raise NotImplementedError("make_ep_mesh (expert parallelism) is not ported yet "
                              "(ROADMAP.md queue 1, item 12e)")


class MoEFFN(nn.Module):
    """Drop-in replacement for the dense MLP: each token goes to its
    ``top_k`` experts. Each expert takes at most ``C = max(1,
    ceil(capacity_factor * top_k * B * T / n_experts))`` tokens (pad tokens
    count in ``B * T``); a token past its expert's capacity gets a zero
    delta from it.

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

    @torch.no_grad()
    def init_from(self, generator: torch.Generator) -> None:
        """flax's initialisation of the five parameters (see the class)."""
        self.router.normal_(0.0, 0.02, generator=generator)
        for w in (self.w_in, self.w_out):
            std = 1.0 / math.sqrt(w.shape[0] * w.shape[1]) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        self.b_in.zero_()
        self.b_out.zero_()

    def capacity(self, n_tokens: int) -> int:
        k = min(self.top_k, self.n_experts)
        return max(1, int(math.ceil(self.capacity_factor * k * n_tokens / self.n_experts)))

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, d = x.shape
        e, k, n = self.n_experts, min(self.top_k, self.n_experts), b * t
        c = self.capacity(n)
        xt = x.reshape(n, d)
        v = (torch.ones(n, device=x.device) if valid is None
             else valid.reshape(n).to(x.device, torch.float32))
        probs = torch.softmax(xt.float() @ self.router.float(), dim=-1)  # [N, E]

        # iterative top-k (GShard priority): every token's k-th choice
        # queues behind all the (k-1)-th choices, so `count` carries the
        # occupancy of the earlier rounds into the slot positions
        masked, count = probs, torch.zeros(e, device=x.device)
        dispatch = torch.zeros(n, e, c, device=x.device)
        gates, top1 = [], None
        for _ in range(k):
            idx = masked.argmax(dim=-1)  # ties go to the first expert
            top1 = idx if top1 is None else top1
            gate = probs.gather(1, idx[:, None])[:, 0]
            raw = F.one_hot(idx, e).float()  # [N, E]
            onehot = raw * v[:, None]  # pad tokens claim no slot
            pos = onehot.cumsum(dim=0) - 1.0 + count
            pos_k = pos.gather(1, idx[:, None])[:, 0]
            keep = (pos_k < c).float()
            slot = F.one_hot(pos_k.clamp(0, c - 1).long(), c).float()
            disp_k = onehot[:, :, None] * slot[:, None, :] * keep[:, None, None]
            dispatch = dispatch + disp_k
            gates.append((gate, disp_k))
            count = count + onehot.sum(dim=0)
            masked = masked * (1.0 - raw)

        # K > 1: gates normalised over the top k (GShard, Mixtral); K = 1:
        # the raw router probability (Switch), which keeps the router on
        # the main gradient path
        total = sum(g for g, _ in gates)
        denom = total.clamp_min(1e-9) if k > 1 else 1.0
        combine = sum((g / denom)[:, None, None] * dk for g, dk in gates)  # [N, E, C]

        cd = self.dtype
        expert_in = torch.einsum("nec,nd->ecd", dispatch.to(cd), xt.to(cd))
        h = (torch.einsum("ecd,edf->ecf", expert_in, cast_param(self.w_in, cd))
             + cast_param(self.b_in, cd)[:, None, :])
        h = F.gelu(h, approximate="tanh")
        out = (torch.einsum("ecf,efd->ecd", h, cast_param(self.w_out, cd))
               + cast_param(self.b_out, cd)[:, None, :])
        y = torch.einsum("nec,ecd->nd", combine.to(cd), out)

        # Switch balance loss over the real tokens: E * sum_e (top-1
        # fraction_e * mean router probability_e)
        n_valid = v.sum().clamp_min(1.0)
        frac = (F.one_hot(top1, e).float() * v[:, None]).sum(dim=0) / n_valid
        p_mean = (probs * v[:, None]).sum(dim=0) / n_valid
        sow("moe_aux", e * (frac * p_mean).sum())
        return y.reshape(b, t, d).to(x.dtype)


def moe_aux_loss(intermediates: Mapping) -> torch.Tensor:
    """The mean of every ``"moe_aux"`` a forward sowed (one per MoE layer,
    a layer LayerDrop dropped included); 0 when there is none."""
    leaves = list(intermediates.get("moe_aux", ()))
    if not leaves:
        return torch.zeros(())
    return torch.stack(leaves).mean()
