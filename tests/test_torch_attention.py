"""Port attention against the JAX reference and the Pallas kernel (CPU).

The port's plain version and its ``fused_attention`` wrapper on CPU
tensors are held against ``avsl_tpu``'s ``_reference_attention`` and its
Pallas forward run in interpret mode (block_q=16, so T=24 pads a q
block), on the cases of tests/test_attention.py plus Tq != Tk. fp32,
atol 1e-5 (the precedent of tests/test_attention.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avsl_tpu.kernels import attention as A
from avsl_tpu_torch.kernels.attention import (
    _check_shapes,
    _check_tma,
    flash_attention_fwd_cuda,
    fused_attention,
    reference_attention,
)

CASES = {
    # name: (b, tq, tk, h, d, causal, lengths)
    "plain": (2, 24, 24, 2, 16, False, None),
    "causal": (2, 24, 24, 2, 16, True, None),
    "lengths": (2, 24, 24, 2, 16, False, [10, 24]),
    "causal_lengths": (2, 24, 24, 2, 16, True, [10, 24]),
    "length_zero_row": (2, 8, 8, 2, 16, False, [0, 8]),
    "cross_tq_ne_tk": (2, 5, 24, 2, 16, False, None),
    "cross_lengths": (2, 5, 24, 2, 16, False, [7, 24]),
}


def _inputs(b, tq, tk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda t: rng.normal(size=(b, t, h, d)).astype(np.float32)  # noqa: E731
    return mk(tq), mk(tk), mk(tk)


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_attention_matches_jax(case):
    b, tq, tk, h, d, causal, lengths = CASES[case]
    q, k, v = _inputs(b, tq, tk, h, d)
    lens_np = None if lengths is None else np.asarray(lengths, np.int32)
    tr = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731  [B,T,H,D] -> [B,H,T,D]

    want_ref = np.asarray(A._reference_attention(
        jnp.asarray(tr(q)), jnp.asarray(tr(k)), jnp.asarray(tr(v)),
        None if lens_np is None else jnp.asarray(lens_np), causal))
    lens_t = None if lens_np is None else torch.from_numpy(lens_np)
    plain = reference_attention(
        torch.from_numpy(tr(q)), torch.from_numpy(tr(k)), torch.from_numpy(tr(v)),
        lens_t, causal).numpy()
    fused = fused_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        lengths=lens_t, causal=causal).numpy()
    np.testing.assert_allclose(plain, want_ref, atol=1e-5)
    np.testing.assert_allclose(tr(fused), want_ref, atol=1e-5)
    want_pallas = np.asarray(A._flash_fwd_pallas(
        jnp.asarray(tr(q)), jnp.asarray(tr(k)), jnp.asarray(tr(v)),
        None if lens_np is None else jnp.asarray(lens_np),
        causal=causal, block_q=16, interpret=True))
    np.testing.assert_allclose(tr(fused), want_pallas, atol=1e-5)
    assert np.isfinite(fused).all()


def test_torch_attention_length_zero_row_is_mean_of_v():
    q, k, v = _inputs(2, 8, 8, 2, 16, seed=1)
    out = fused_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          lengths=torch.tensor([0, 8])).numpy()
    np.testing.assert_allclose(out[0], np.broadcast_to(v[0].mean(0), out[0].shape), atol=1e-5)


def test_torch_attention_wrapper_counts_only_kernel_launches():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 4, 4, 1, 32))
    before = fused_attention.launches
    fused_attention(q, k, v)
    assert fused_attention.launches == before  # CPU tensors: plain version


def test_torch_attention_kernel_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 4, 4, 1, 32))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd_cuda(q, k, v)


@pytest.mark.parametrize("view", ["contiguous", "head_slice", "fp32_odd_offset"])
def test_torch_attention_tma_check_accepts_what_tma_reads(view):
    """bf16 operands reach the kernels by TMA: 16-byte aligned bases and
    strides pass the wrapper's check (an fp32 operand is not checked)."""
    base = torch.zeros((2, 9, 4, 64), dtype=torch.bfloat16)
    t = {"contiguous": base, "head_slice": base[:, :, 1:3],
         "fp32_odd_offset": torch.zeros(2 * 9 * 4 * 64 + 1)[1:].view(2, 9, 4, 64)}[view]
    _check_tma([("q", t)])


@pytest.mark.parametrize("view", ["odd_base", "odd_time_stride"])
def test_torch_attention_tma_check_refuses_what_tma_cannot_read(view):
    n = 2 * 9 * 4 * 64
    make = {  # a base 2 bytes past alignment; a time stride of 260 elements (520 bytes)
        "odd_base": lambda: torch.zeros(n + 8, dtype=torch.bfloat16)[1:1 + n].view(2, 9, 4, 64),
        "odd_time_stride": lambda: torch.zeros((2, 9, 260), dtype=torch.bfloat16)[..., :256]
        .unflatten(-1, (4, 64)),
    }
    t = make[view]()
    with pytest.raises(ValueError, match="TMA"):
        _check_tma([("q", t)])


@pytest.mark.parametrize("case", ["no_mask", "cache_prefix_mask", "cross_one_query"])
def test_torch_dot_product_attention_matches_jax(case):
    """The decode-path attention (fp32 products, ``finfo(float32).min``
    mask) against ``avsl_tpu.models.layers.dot_product_attention``."""
    from avsl_tpu.models.layers import dot_product_attention as jax_dpa
    from avsl_tpu_torch.models.layers import dot_product_attention

    tq, tk = {"no_mask": (6, 6), "cache_prefix_mask": (3, 10), "cross_one_query": (1, 24)}[case]
    q, k, v = _inputs(2, tq, tk, 2, 16, seed=2)
    mask = None
    if case == "cache_prefix_mask":  # query i at position 4 + i sees keys <= 4 + i
        mask = (np.arange(tk)[None, :] <= np.arange(tq)[:, None] + 4)[None, None]
    want = np.asarray(jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              None if mask is None else jnp.asarray(mask)))
    got = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


# the bodies the wrapper took last: head dim 16 (tiny_test's) in both
# types and fp32 at 128; causal with key lengths and a length-0 row
NEW_BODIES = {
    "fp32_d16": (torch.float32, 16),
    "bf16_d16": (torch.bfloat16, 16),
    "fp32_d128": (torch.float32, 128),
}


@pytest.mark.parametrize("body", sorted(NEW_BODIES))
def test_torch_attention_new_bodies_accepted_and_match_jax(body):
    """The wrapper's shape check takes these head dims, and its CPU plain
    path matches ``avsl_tpu.kernels.attention`` there (fp32 1e-5; bf16
    within chip_smoke.py's BF16_TOL, both sides rounding the weights to
    bf16 before the PV product)."""
    from chip_smoke import BF16_TOL, D16_LENGTHS

    dtype, d = NEW_BODIES[body]
    b, tq, h = 4, 37, 2
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _inputs(b, tq, tq, h, d, seed=3))
    _check_shapes(q, k, v)
    lengths = [min(n, tq) for n in D16_LENGTHS]
    lens = torch.tensor(lengths, dtype=torch.int32)
    got = fused_attention(q, k, v, lengths=lens, causal=True)
    tr = lambda x: jnp.asarray(x.float().numpy().transpose(0, 2, 1, 3))  # noqa: E731
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(A._reference_attention(
        tr(q).astype(jdt), tr(k).astype(jdt), tr(v).astype(jdt),
        jnp.asarray(np.asarray(lengths, np.int32)), True).astype(jnp.float32))
    tol = dict(atol=1e-5, rtol=0.0) if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got.float().numpy().transpose(0, 2, 1, 3), want, **tol)
    mean_v = v[2].float().mean(dim=0)  # the length-0 row: uniform weights
    np.testing.assert_allclose(got[2].float().numpy(),
                               np.broadcast_to(mean_v.numpy(), got[2].shape), **tol)
