"""Port attention backward against the JAX Pallas backward kernel (CPU).

The port's plain backward ``reference_attention_bwd`` is held against
``avsl_tpu``'s ``_flash_bwd_pallas`` run in interpret mode (block_q=16, so
T=24 pads a q block) on the cases of tests/test_attention.py plus a
length-0 row and D=32, at atol 2e-4 (the tolerance of
tests/test_attention.py for the Pallas backward; both sides are fp32 and
sum in different orders). The autograd ``Function`` behind
``fused_attention`` is held against ``torch.autograd`` of the plain
forward where no row is fully masked (atol 1e-5, fp32: the same math in
another order), and the plain row statistics against the forward.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avsl_tpu.kernels import attention as A
from avsl_tpu_torch.kernels.attention import (
    flash_attention_bwd_cuda,
    fused_attention,
    fused_attention_bwd,
    reference_attention,
    reference_attention_bwd,
    reference_attention_stats,
)

CASES = {
    # name: (b, t, h, d, causal, lengths)
    "plain": (2, 24, 2, 16, False, None),
    "causal": (2, 24, 2, 16, True, None),
    "lengths": (2, 24, 2, 16, False, [10, 24]),
    "causal_lengths": (2, 24, 2, 16, True, [10, 24]),
    "length_zero_row": (2, 24, 2, 16, False, [0, 24]),
    "causal_length_zero_row": (2, 24, 2, 16, True, [0, 24]),
    "head_dim_32": (2, 24, 2, 32, False, [17, 24]),
}


def _head_major_inputs(b, tq, tk, h, d, seed=0):
    """q, k, v, dO as [B,H,T,D] float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    mk = lambda t: rng.normal(size=(b, h, t, d)).astype(np.float32)  # noqa: E731
    return mk(tq), mk(tk), mk(tk), mk(tq)


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_attention_bwd_matches_pallas_kernel(case):
    b, t, h, d, causal, lengths = CASES[case]
    q, k, v, g = _head_major_inputs(b, t, t, h, d)
    lens_np = None if lengths is None else np.asarray(lengths, np.int32)
    lens_j = None if lens_np is None else jnp.asarray(lens_np)
    out = np.array(A._flash_fwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       lens_j, causal=causal, block_q=16, interpret=True))
    want = A._flash_bwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(out), jnp.asarray(g), lens_j,
                               causal=causal, block_q=16, interpret=True)
    got = reference_attention_bwd(
        *(torch.from_numpy(x) for x in (q, k, v, out, g)),
        None if lens_np is None else torch.from_numpy(lens_np), causal)
    for name, w, x in zip(("dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), atol=2e-4, err_msg=name)


def test_torch_attention_bwd_length_zero_row_differs_from_autograd():
    """K2 forms dS at every key of a length-0 row (uniform weights), where
    autograd of the forward gives dQ = dK = 0; dV agrees."""
    q, k, v, g = (torch.from_numpy(x) for x in _head_major_inputs(2, 24, 24, 2, 16))
    lens = torch.tensor([0, 24])
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    out = reference_attention(qa, ka, va, lens, False)
    out.backward(g)
    dq, dk, dv = reference_attention_bwd(q, k, v, out.detach(), g, lens, False)
    assert qa.grad[0].abs().max() == 0 and ka.grad[0].abs().max() == 0
    assert dq[0].abs().max() > 1e-2 and dk[0].abs().max() > 1e-2
    np.testing.assert_allclose(dv.numpy(), va.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(dq[1].numpy(), qa.grad[1].numpy(), atol=1e-5)


FN_CASES = {
    # name: (b, tq, tk, h, d, causal, lengths); no row is fully masked
    "plain": (2, 24, 24, 2, 16, False, None),
    "causal": (2, 24, 24, 2, 16, True, None),
    "lengths": (2, 24, 24, 2, 16, False, [10, 24]),
    "causal_lengths": (2, 24, 24, 2, 16, True, [10, 24]),
    "cross_tq_ne_tk": (2, 5, 24, 2, 32, False, [7, 24]),
}


@pytest.mark.parametrize("case", sorted(FN_CASES))
def test_torch_fused_attention_function_matches_autograd(case):
    b, tq, tk, h, d, causal, lengths = FN_CASES[case]
    q, k, v, g = (torch.from_numpy(x).transpose(1, 2)
                  for x in _head_major_inputs(b, tq, tk, h, d, seed=3))  # [B,T,H,D]
    lens = None if lengths is None else torch.tensor(lengths)

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fused_attention(*leaves, lengths=lens, causal=causal)
    assert out.grad_fn is not None
    out.backward(g)

    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = reference_attention(*(x.transpose(1, 2) for x in ref_leaves), lens, causal)
    ref.transpose(1, 2).backward(g)
    np.testing.assert_allclose(out.detach().numpy(), ref.transpose(1, 2).detach().numpy(),
                               atol=1e-5)
    for name, a, r in zip("qkv", leaves, ref_leaves):
        np.testing.assert_allclose(a.grad.numpy(), r.grad.numpy(), atol=1e-5, err_msg=name)


def test_torch_fused_attention_without_grad_is_the_plain_forward():
    q, k, v, _ = (torch.from_numpy(x).transpose(1, 2) for x in _head_major_inputs(1, 6, 6, 2, 32))
    out = fused_attention(q, k, v, causal=True)
    assert out.grad_fn is None
    with torch.no_grad():
        out2 = fused_attention(q.requires_grad_(), k, v, causal=True)
    assert out2.grad_fn is None
    np.testing.assert_array_equal(out.numpy(), out2.numpy())


@pytest.mark.parametrize("case", ["plain", "causal_lengths", "length_zero_row"])
def test_torch_attention_stats_match_forward(case):
    """m is the row max and l the row sum of exp(logits - m); the weights
    exp(logits - m) / l they give reproduce the forward's output, on a
    length-0 row too (m = -1e30, l = Tk)."""
    b, t, h, d, causal, lengths = CASES[case]
    q, k, v, _ = (torch.from_numpy(x) for x in _head_major_inputs(b, t, t, h, d, seed=5))
    lens = None if lengths is None else torch.tensor(lengths)
    m, l = reference_attention_stats(q, k, lens, causal)
    assert m.shape == l.shape == (b, h, t) and m.dtype == l.dtype == torch.float32
    logits = torch.matmul(q, k.transpose(-1, -2)) / np.sqrt(d)
    if causal:
        logits = logits.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), -1e30)
    if lens is not None:
        logits = logits.masked_fill((torch.arange(t)[None, :] >= lens[:, None])[:, None, None],
                                    -1e30)
    np.testing.assert_allclose(m.numpy(), logits.amax(-1).numpy(), rtol=1e-6)
    weights = torch.exp(logits - m[..., None]) / l[..., None]
    np.testing.assert_allclose(torch.matmul(weights, v).numpy(),
                               reference_attention(q, k, v, lens, causal).numpy(), atol=1e-5)
    if lengths is not None and 0 in lengths:
        row = lengths.index(0)
        assert float(m[row].max()) == float(np.float32(-1e30)) and np.allclose(l[row].numpy(), t)


def test_torch_attention_bwd_wrapper_counts_only_kernel_launches():
    q, k, v, g = (torch.from_numpy(x).transpose(1, 2) for x in _head_major_inputs(1, 4, 4, 1, 32))
    before = fused_attention_bwd.launches
    fused_attention_bwd(q, k, v, q, g)
    assert fused_attention_bwd.launches == before  # CPU tensors: plain version


def test_torch_attention_bwd_kernel_refuses_cpu_tensors():
    q, k, v, g = (torch.from_numpy(x).transpose(1, 2) for x in _head_major_inputs(1, 4, 4, 1, 32))
    m = torch.zeros(1, 1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(q, k, v, q, g, m, m)
