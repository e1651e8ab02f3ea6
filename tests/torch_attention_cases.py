"""Inputs shared by the attention kernels' checks: the key lengths of the
causal-with-lengths cases and the magnitude sums behind K2's bf16 limit.
``tests/test_torch_attention.py`` and ``test_torch_attention_numerics.py``
use them on the CPU, and the card gate at the repository root on the
card."""

import math

import torch

# decoder key lengths (non-pad tokens) of an AMI AV-HuBERT batch of 8
# (labels of 20-63 tokens cut to 64, and two rows of 1 and 2), and a D = 64
# case of 100 tokens
AMI_DEC_LENGTHS = [64, 1, 40, 17, 63, 2, 33, 64]
D64_CAUSAL_LENGTHS = [100, 1, 37, 64, 65, 99, 2, 100]
# the tiny_test head dim 16, causal with key lengths: a length-0 row among them
D16_LENGTHS = [100, 37, 0, 1]


def bwd_magnitudes(q, k, v, o, g, lens, causal):
    """[B,T,H,D] fp32 sums of magnitudes behind each gradient element:
    |dS| |K| / sqrt(D) (dQ), |dS|^T |Q| / sqrt(D) (dK) and |P|^T |dO|
    (dV), with P and dS as the plain backward forms them."""
    from avsl_tpu_torch.kernels.attention import _masked_logits

    qh, kh, vh, oh, gh = (t.transpose(1, 2).float() for t in (q, k, v, o, g))
    p = torch.softmax(_masked_logits(qh, kh, lens, causal), dim=-1)
    delta = (gh * oh).sum(dim=-1, keepdim=True)
    ds = (p * (torch.matmul(gh, vh.transpose(-1, -2)) - delta)).abs() / math.sqrt(q.shape[-1])
    mags = (torch.matmul(ds, kh.abs()), torch.matmul(ds.transpose(-1, -2), qh.abs()),
            torch.matmul(p.transpose(-1, -2), gh.abs()))
    return [m.transpose(1, 2) for m in mags]
