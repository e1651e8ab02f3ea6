"""Seed-made weights: every tensor of a configuration's state dict drawn
on the device from one ``torch.Generator``, in a few large calls.

The draws are made in chunks of at most ``CHUNK`` elements, in the order
of the spec, then cut, scaled and shifted per tensor, so the same seed
gives the same weights on the same device, for the program and for the
reference alike.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.spec import Spec
from portbench.reference.whisper_flamingo import sinusoids

CHUNK = 1 << 28


def make(spec: Spec, seed: int, device, gate: float = 0.5,
         bf16_values: bool = False) -> Dict[str, torch.Tensor]:
    """The fp32 state dict of ``spec``. With ``bf16_values`` every value is
    rounded to the nearest bf16 (still held in fp32): the served model
    stores its weights in bf16, and this way the program and the
    reference get the same values whatever dtype the program keeps each
    tensor in."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    scales = {"fan_in": None, "bias": 0.02, "mean": 0.05, "pos": 0.01}
    normal = [(n, s, k) for n, s, k in spec if k in ("fan_in", "bias", "scale", "pos", "mean")]
    uniform = [(n, s, k) for n, s, k in spec if k in ("var", "uniform")]
    out: Dict[str, torch.Tensor] = {}

    def fill(group, draw):
        buf, used = None, 0
        for name, shape, kind in group:
            n = math.prod(shape)
            if buf is None or used + n > buf.numel():
                buf, used = draw(max(CHUNK, n)), 0
            t = buf[used:used + n].view(shape)
            used += n
            if kind == "fan_in":
                t = t * (1.0 / math.sqrt(math.prod(shape[1:])))
            elif kind == "scale":
                t = 1.0 + 0.05 * t
            elif kind == "var":
                t = 0.9 + 0.2 * t
            elif kind in scales:
                t = t * scales[kind]
            out[name] = t
        del buf

    fill(normal, lambda n: torch.randn(n, generator=gen, device=device))
    fill(uniform, lambda n: torch.rand(n, generator=gen, device=device))
    for name, shape, kind in spec:
        if kind == "gate":
            out[name] = torch.full(shape, float(gate), device=device)
        elif kind == "prelu":
            out[name] = torch.full(shape, 0.25, device=device)
        elif kind == "sinusoid":
            out[name] = sinusoids(*shape).to(device)
    sd = {name: out.pop(name) for name, _, _ in spec}
    if bf16_values:
        for t in sd.values():
            t.copy_(t.to(torch.bfloat16))
    return sd
