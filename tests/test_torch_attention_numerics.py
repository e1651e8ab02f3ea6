"""The tensor-core kernels' rounding points, emulated on the CPU.

The bf16 bodies of ``csrc/flash_attn_fwd.cu`` (K1) and
``csrc/flash_attn_bwd.cu`` (K2) round at other points than the plain
versions that the card gate at the repository root holds them to on
the card:

- K1 runs an online softmax over 64-key tiles in log2 units (the scale
  times log2(e), exp2), rounds the *unnormalised* exp2(x - m) to bf16 as
  the A operand of the PV product, accumulates in fp32 and divides once
  by the fp32 row sum l, which is summed from the fp32 exponentials; it
  writes m back in natural-log units (the masked -1e30 exactly);
- K2 recomputes P from m and l, and rounds P and dS = P (dP - delta) to
  bf16 as product operands, accumulating in fp32 and applying 1/sqrt(D)
  to the dQ and dK accumulators.

The plain versions round the *normalised* P (forward) or nothing (backward).
These tests emulate the kernels' arithmetic in plain torch and hold it to
``reference_attention`` / ``reference_attention_bwd`` within the card's
``BF16_TOL``, and the emulated m and l to ``reference_attention_stats``
within ``STATS_TOL`` (both from ``kernels/attention.py``), on
the card gate's bf16 cases at H = 2 (B = 2 for the 1500-frame encoder,
to bound memory), the AV-HuBERT decoder's D = 128, the tiny_test head dim
16 and the causal-with-lengths cases among them; those hold K2 to the limit
with the magnitude term ``BF16_MAGNITUDE``.
So the tolerances are known to hold at the new rounding points before the
card checks the kernels themselves.
"""

import math

import numpy as np
import pytest
import torch

from avsl_tpu_torch.kernels.attention import (
    BF16_MAGNITUDE,
    BF16_TOL,
    STATS_TOL,
    reference_attention,
    reference_attention_bwd,
    reference_attention_stats,
)
from torch_attention_cases import AMI_DEC_LENGTHS, D16_LENGTHS, D64_CAUSAL_LENGTHS, bwd_magnitudes

LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
MASKED = np.float32(-1.0e30)
MASKED2 = float(MASKED * LOG2E)  # the kernels' masked logit in log2 units
TILE = 64

CASES = {
    # name: (b, h, tq, tk, d, causal, lengths), the card gate's bf16 cases at H = 2
    "encoder": (2, 2, 1500, 1500, 64, False, None),
    "decoder_self_causal": (8, 2, 448, 448, 64, True, None),
    "cross": (8, 2, 70, 1500, 64, False, None),
    "ragged_lengths": (4, 2, 1003, 1003, 64, False, [0, 1003, 517, 1]),
    "tiny_head_dim": (8, 2, 200, 200, 32, False, None),
    "avhubert_decoder_self_ami": (8, 2, 64, 64, 128, True, AMI_DEC_LENGTHS),
    "head_dim_128": (2, 2, 250, 250, 128, False, None),
    "causal_lengths_d64": (8, 2, 100, 100, 64, True, D64_CAUSAL_LENGTHS),
    "head_dim_16": (8, 2, 200, 200, 16, False, None),
    "head_dim_16_causal_lengths": (4, 2, 100, 100, 16, True, D16_LENGTHS),
}
# the cases whose K2 limit adds BF16_MAGNITUDE times each element's
# magnitude sum, as the card gate's do
MAGNITUDE_CASES = {"avhubert_decoder_self_ami", "head_dim_128", "causal_lengths_d64",
                   "head_dim_16_causal_lengths"}


def _inputs(b, h, tq, tk, d, seed=0):
    """q, k, v, dO as bf16 [B,H,T,D] from a numpy seed."""
    rng = np.random.default_rng(seed)
    mk = lambda t: torch.from_numpy(rng.normal(size=(b, h, t, d)).astype(np.float32))  # noqa: E731
    return tuple(x.to(torch.bfloat16) for x in (mk(tq), mk(tk), mk(tk), mk(tq)))


def _logits_log2(q, k, lengths, causal, k0, k1):
    """fp32 logits of keys k0:k1 in log2 units with the kernels' masking."""
    scale_log2 = np.float32(1.0 / math.sqrt(q.shape[-1])) * LOG2E
    x = torch.matmul(q.float(), k[:, :, k0:k1].float().transpose(-1, -2)) * float(scale_log2)
    keys = torch.arange(k0, k1)
    masked = torch.zeros(x.shape[-2:], dtype=torch.bool)
    if causal:
        masked = masked | (keys[None, :] > torch.arange(q.shape[2])[:, None])
    masked = masked[None, None]
    if lengths is not None:
        masked = masked | (keys[None, None, None, :] >= lengths[:, None, None, None])
    return torch.where(masked, torch.tensor(MASKED2), x)


def emulate_k1(q, k, v, lengths, causal):
    """K1's bf16 arithmetic: (out bf16, m, l) over [B,H,T,D] operands."""
    b, h, tq, _ = q.shape
    m = torch.full((b, h, tq), -math.inf)
    l = torch.zeros((b, h, tq))
    acc = torch.zeros((b, h, tq, v.shape[-1]))
    for k0 in range(0, k.shape[2], TILE):
        k1 = min(k0 + TILE, k.shape[2])
        x = _logits_log2(q, k, lengths, causal, k0, k1)
        m_new = torch.maximum(m, x.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.matmul(p.to(torch.bfloat16).float(), v[:, :, k0:k1].float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = (acc / l[..., None]).to(torch.bfloat16)
    m_nat = torch.where(m == MASKED2, torch.tensor(float(MASKED)), m * float(LN2))
    return out, m_nat, l


def emulate_k2(q, k, v, o, do, m, l, lengths, causal):
    """K2's bf16 arithmetic from K1's m and l: (dq, dk, dv) bf16."""
    scale = np.float32(1.0 / math.sqrt(q.shape[-1]))
    m2 = torch.where(m == float(MASKED), torch.tensor(MASKED2), m * float(LOG2E))
    x = _logits_log2(q, k, lengths, causal, 0, k.shape[2])
    p = torch.exp2(x - m2[..., None]) / l[..., None]
    g = do.float()
    delta = (g * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(g, v.float().transpose(-1, -2)) - delta)
    p16, ds16 = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    dv = torch.matmul(p16.transpose(-1, -2), g)
    dk = torch.matmul(ds16.transpose(-1, -2), q.float()) * float(scale)
    dq = torch.matmul(ds16, k.float()) * float(scale)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def _assert_close(got, want, tol, what, magnitude=0.0):
    err = (got.float() - want.float()).abs()
    limit = tol["atol"] + tol["rtol"] * want.float().abs() + BF16_MAGNITUDE * magnitude
    assert bool((err <= limit).all()), f"{what}: max abs err {err.max().item():.3e} over {tol}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_attention_numerics_k1_rounding_within_card_tolerance(case):
    b, h, tq, tk, d, causal, lengths = CASES[case]
    q, k, v, _ = _inputs(b, h, tq, tk, d)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    out, m, l = emulate_k1(q, k, v, lens, causal)
    assert torch.isfinite(out.float()).all()
    _assert_close(out, reference_attention(q, k, v, lens, causal), BF16_TOL, "out")
    want_m, want_l = reference_attention_stats(q, k, lens, causal)
    _assert_close(m, want_m, STATS_TOL, "m")
    _assert_close(l, want_l, STATS_TOL, "l")
    for bi, n in enumerate(lengths or []):
        if n == 0:  # uniform weights over all Tk keys: the mean of V, m exactly -1e30
            mean_v = v[bi].float().mean(dim=1, keepdim=True)
            assert (out[bi].float() - mean_v).abs().max().item() <= BF16_TOL["atol"]
            assert bool((m[bi] == float(MASKED)).all())


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_attention_numerics_k2_rounding_within_card_tolerance(case):
    b, h, tq, tk, d, causal, lengths = CASES[case]
    q, k, v, do = _inputs(b, h, tq, tk, d, seed=1)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    o, m, l = emulate_k1(q, k, v, lens, causal)
    got = emulate_k2(q, k, v, o, do, m, l, lens, causal)
    want = reference_attention_bwd(q, k, v, o, do, lens, causal)
    mags = [0.0] * 3
    if case in MAGNITUDE_CASES:
        bthd = [t.transpose(1, 2) for t in (q, k, v, o, do)]
        mags = [m.transpose(1, 2) for m in bwd_magnitudes(*bthd, lens, causal)]
    for name, x, w, mag in zip(("dq", "dk", "dv"), got, want, mags):
        assert torch.isfinite(x.float()).all(), name
        _assert_close(x, w, BF16_TOL, name, mag)
