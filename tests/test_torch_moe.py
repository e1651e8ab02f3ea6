"""The MoE FFN of the port (``models/moe.py``) against the JAX package (CPU).

The cases of ``tests/test_moe.py`` that need no mesh, on the port: the
dense dispatch equals a per-token brute-force top-k mixture (K = 1 and 2)
when the capacity admits every token; an overflowing token gets a zero
delta; the Switch loss is 1 at balance; the router gets a gradient; the
block's wiring; padding invariance through ``valid`` and through the
block's ``kv_lengths``. Then JAX against the port on carried parameters:
``MoEFFN``'s output, its balance loss and the gradients of
``sum(y^2) + 0.01 aux`` in fp32 (atol 1e-5 + rtol 1e-4) and in bf16
compute (the kernels' BF16_TOL); flax's initialisation; the aux of
every layer LayerDrop drops; remat counting the first forward's aux once
with the same gradients; and the parallel entry points on one rank,
refusing what JAX refuses on one device. The losses with an MoE trunk are
in ``tests/test_torch_moe_losses.py``; expert parallelism and the global
routing on a mesh in ``tests/test_torch_ep.py``.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.models.moe import MoEFFN as JaxMoE
from avsl_tpu.models.moe import moe_aux_loss as jax_moe_aux_loss
from avsl_tpu_torch.kernels.attention import BF16_TOL
from avsl_tpu_torch.models.intermediates import collect_intermediates
from avsl_tpu_torch.models.layers import TransformerBlock
from avsl_tpu_torch.models.moe import MoEFFN, make_ep_mesh, moe_aux_loss
from test_torch_avhubert_models import TOL, av_inputs, close, t
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)

D, FF = 8, 16


def _moe(E, K, cf, seed=0, **kw):
    m = MoEFFN(D, FF, E, top_k=K, capacity_factor=cf, dtype=torch.float32,
               param_dtype=torch.float32, **kw)
    m.init_from(torch.Generator().manual_seed(seed))
    return m


def _x(B=2, T=6, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(B, T, D)).astype(np.float32))


def _gelu_tanh(h):
    return 0.5 * h * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (h + 0.044715 * h ** 3)))


def _brute_force_topk(m, x, K):
    """Per token: its top-k experts, gates normalised over the top k (the
    raw probability for K = 1), each expert's MLP with the tanh GELU the
    module (as flax's ``nn.gelu``) computes, in float64."""
    xt = x.double().reshape(-1, D).numpy()
    p = {k: v.detach().double().numpy() for k, v in m.named_parameters()}
    logits = xt @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    y = np.zeros_like(xt)
    for n in range(xt.shape[0]):
        order = np.argsort(-probs[n])[:K]
        gates = probs[n][order]
        denom = gates.sum() if K > 1 else 1.0
        for e, g in zip(order, gates):
            h = _gelu_tanh(xt[n] @ p["w_in"][e] + p["b_in"][e])
            y[n] += (g / denom) * (h @ p["w_out"][e] + p["b_out"][e])
    return y.reshape(x.shape)


@pytest.mark.parametrize("K", [1, 2])
def test_torch_moe_matches_brute_force_topk(K):
    E = 4
    m, x = _moe(E, K, cf=float(E)), _x()  # C = K N: nothing overflows
    with torch.no_grad():
        y = m(x)
    np.testing.assert_allclose(y.double().numpy(), _brute_force_topk(m, x, K), atol=1e-4)


def test_torch_moe_capacity_overflow_is_zero_delta():
    m = _moe(2, 1, cf=0.01)
    x = _x(B=1, T=8).abs() + 0.1
    with torch.no_grad():
        m.router.zero_()
        m.router[:, 0], m.router[:, 1] = 1.0, -1.0  # every token to expert 0, C = 1
        y = m(x).reshape(-1, D)
    nonzero = y.abs().sum(-1) > 1e-9
    assert nonzero[0] and not nonzero[1:].any()


def test_torch_moe_aux_loss_is_one_at_balance():
    m = _moe(4, 2, cf=2.0)
    with torch.no_grad():
        m.router.zero_()
        with collect_intermediates() as inter:
            m(_x())
    assert float(moe_aux_loss(inter)) == pytest.approx(1.0, abs=1e-5)
    assert float(moe_aux_loss({})) == 0.0


@pytest.mark.parametrize("K", [1, 2])
def test_torch_moe_router_gets_gradient(K):
    m = _moe(4, K, cf=4.0)
    (m(_x()) ** 2).sum().backward()
    assert float(m.router.grad.abs().max()) > 0.0


def test_torch_transformer_block_moe_wiring():
    for names in ("whisper", "fairseq"):
        block = TransformerBlock(16, 2, 32, n_experts=4, dtype=torch.float32, names=names)
        for mod in block.modules():
            if hasattr(mod, "init_from"):
                mod.init_from(torch.Generator().manual_seed(0))
        params = {n for n, _ in block.named_parameters() if n.startswith("mlp.")}
        assert params == {f"mlp.{k}" for k in ("router", "w_in", "b_in", "w_out", "b_out")}
        assert not hasattr(block, "fc1")
        x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 6, 16)).astype(np.float32))
        with torch.no_grad(), collect_intermediates() as inter:
            y, _ = block(x)
        assert y.shape == x.shape and len(inter["moe_aux"]) == 1
        assert float(moe_aux_loss(inter)) > 0.0


def test_torch_moe_padding_mask_invariance():
    """Pad positions with ``valid`` 0: real outputs unchanged, pads a zero
    delta, the balance statistics over the real tokens only."""
    E = 4
    m, x = _moe(E, 2, cf=float(E)), _x()
    b, T, _ = x.shape
    with torch.no_grad():
        with collect_intermediates() as ref_inter:
            y_ref = m(x)
        xp = torch.cat([x, torch.zeros(b, 3, D)], dim=1)
        valid = torch.cat([torch.ones(b, T), torch.zeros(b, 3)], dim=1)
        with collect_intermediates() as pad_inter:
            y_pad = m(xp, valid=valid)
    torch.testing.assert_close(y_pad[:, :T], y_ref, atol=1e-6, rtol=0)
    assert float(y_pad[:, T:].abs().max()) == 0.0
    assert float(moe_aux_loss(pad_inter)) == pytest.approx(float(moe_aux_loss(ref_inter)),
                                                          abs=1e-6)


def test_torch_transformer_block_moe_padding_via_kv_lengths():
    block = TransformerBlock(16, 2, 32, n_experts=4, moe_capacity_factor=4.0,
                             dtype=torch.float32, names="fairseq", use_k_bias=True)
    block.mlp.init_from(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 5, 16)).astype(np.float32))
    lengths = torch.tensor([5, 5], dtype=torch.int32)
    with torch.no_grad():
        y_ref, _ = block(x, kv_lengths=lengths)
        y_pad, _ = block(torch.cat([x, torch.zeros(2, 4, 16)], dim=1), kv_lengths=lengths)
    torch.testing.assert_close(y_pad[:, :5], y_ref, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# against the JAX package on carried parameters
# ---------------------------------------------------------------------------


def _jax_moe(E, K, cf, dtype, seed=0):
    jm = JaxMoE(D, FF, E, top_k=K, capacity_factor=cf, dtype=dtype)
    x = np.random.default_rng(seed).normal(size=(3, 7, D)).astype(np.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    rng = np.random.default_rng(seed + 1)
    # biases off zero, so their products and gradients count
    params = {k: np.asarray(v) + (0.1 * rng.standard_normal(np.shape(v)).astype(np.float32)
                                  if k.startswith("b_") else 0.0) for k, v in params.items()}
    return jm, params, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,cf,padded", [(1, 1.25, False), (2, 1.25, True), (2, 0.5, False)],
                         ids=["top1", "top2_padded", "top2_overflow"])
def test_torch_moe_matches_jax(dtype, K, cf, padded):
    E = 4
    jm, params, x = _jax_moe(E, K, cf, getattr(jnp, dtype))
    valid = None
    if padded:
        valid = (np.arange(x.shape[1])[None] < np.array([7, 3, 5])[:, None]).astype(np.float32)

    def jax_loss(p, xin):
        y, st = jm.apply({"params": p}, xin, valid=None if valid is None else jnp.asarray(valid),
                         mutable=["intermediates"])
        aux = jax_moe_aux_loss(st["intermediates"])
        return jnp.sum(y.astype(jnp.float32) ** 2) + 0.01 * aux, (y, aux)

    (_, (want_y, want_aux)), (want_gp, want_gx) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    port = MoEFFN(D, FF, E, top_k=K, capacity_factor=cf, dtype=getattr(torch, dtype),
                  param_dtype=torch.float32)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    with collect_intermediates() as inter:
        y = port(xt, valid=t(valid))
    aux = moe_aux_loss(inter)
    ((y.float() ** 2).sum() + 0.01 * aux).backward()
    tol = TOL if dtype == "float32" else BF16_TOL
    close(y.float(), np.asarray(want_y, np.float32), tol=tol, err_msg="y")
    close(aux, want_aux, tol=TOL, err_msg="aux")  # routing runs in fp32 either way
    close(xt.grad, want_gx, tol=tol, err_msg="x grad")
    for name, p in port.named_parameters():
        want = np.asarray(want_gp[name], np.float32)
        # a gradient element sums over every token, so its rounding goes
        # with its tensor's size (the rule of test_torch_avhubert_train.py)
        g_tol = dict(tol, atol=max(tol["atol"], tol["rtol"] * float(np.abs(want).max())))
        close(p.grad, want, tol=g_tol, err_msg=name)


def test_torch_moe_init_follows_flax():
    """Router N(0, 0.02); w_in and w_out truncated-normal with variance
    1/fan_in over the expert and input axes; zero biases."""
    m = MoEFFN(64, 128, 8, dtype=torch.float32, param_dtype=torch.float32)
    m.init_from(torch.Generator().manual_seed(0))
    m.requires_grad_(False)
    assert abs(float(m.router.std()) - 0.02) < 2e-3
    for w in (m.w_in, m.w_out):
        fan_in = w.shape[0] * w.shape[1]
        assert abs(float(w.std()) * math.sqrt(fan_in) - 1.0) < 0.05
        assert float(w.abs().max()) <= 2.0 / math.sqrt(fan_in) / 0.87962566103423978 + 1e-6
    assert not m.b_in.any() and not m.b_out.any()


def test_torch_moe_aux_counts_dropped_layers_and_remat_once():
    """LayerDrop 1 drops every layer after its block ran: each still sows
    its aux. Under remat the recompute sows nothing: the loss reads the
    first forward's aux once, and the gradients equal those without remat."""
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.models import build_avhubert

    over = dict(dtype="float32", hidden_dropout=0.0, attention_dropout=0.0,
                activation_dropout=0.0, dropout_input=0.0, modality_dropout=0.0,
                n_experts=4, use_visual=False, modality_fuse="add")
    audio, _, pad, _ = av_inputs(12)
    inputs = dict(audio=t(audio), padding_mask=t(pad))

    model = build_avhubert(AVHuBERTConfig.tiny_test(layerdrop=1.0, **over), "ctc", device="cpu")
    model.train()
    with torch.no_grad(), collect_intermediates() as inter:
        model(**inputs, generator=torch.Generator().manual_seed(0))
    assert len(inter["moe_aux"]) == model.cfg.num_hidden_layers

    grads, auxes = {}, {}
    for remat in (False, True):
        m = build_avhubert(AVHuBERTConfig.tiny_test(layerdrop=0.0, remat=remat, **over), "ctc",
                           device="cpu", seed=1).train()
        with collect_intermediates() as inter:
            out = m(**inputs, generator=torch.Generator().manual_seed(0))
            aux = moe_aux_loss(inter)
            ((out ** 2).mean() + 0.01 * aux).backward()
        assert len(inter["moe_aux"]) == m.cfg.num_hidden_layers  # after the recompute too
        grads[remat] = {n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None}
        auxes[remat] = float(aux)
    assert auxes[True] == auxes[False]
    assert sorted(grads[True]) == sorted(grads[False])
    for n, g in grads[False].items():
        torch.testing.assert_close(grads[True][n], g, atol=1e-6, rtol=1e-5, msg=n)


def test_torch_moe_parallel_entry_points_refuse(tmp_path):
    """The parallel entry points on one rank refuse only what JAX refuses
    on one device: an expert axis that does not divide it
    (``make_ep_mesh(1, 2)`` and the CLI's ``--experts_parallel 2`` /
    ``--model_parallel 2``); ``make_ep_mesh(1, 1)`` is the (data 1, expert
    1) mesh, and a mesh needs the launcher's process group."""
    from avsl_tpu_torch.cli import avhubert_ft
    from torch_mesh_workers import one_rank_group

    with pytest.raises(RuntimeError, match="process group"):
        make_ep_mesh(1, experts_parallel=1)
    with one_rank_group(tmp_path):
        assert make_ep_mesh(1, experts_parallel=1).shape == {"data": 1, "expert": 1}
        with pytest.raises(ValueError, match="not divisible"):
            make_ep_mesh(1, experts_parallel=2)
        for flag in ("--experts_parallel", "--model_parallel"):
            with pytest.raises(ValueError, match="not divisible"):
                avhubert_ft.main(["--smoke", "--device", "cpu", "--n_experts", "4", flag, "2"])
