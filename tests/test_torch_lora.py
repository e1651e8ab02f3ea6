"""LoRA adapters of the port (``models/lora.py``) against the JAX package
(CPU, fp32).

The cases of ``tests/test_lora.py`` (the merged model is the base at step
0, exactly; orphan adapters and a target that matches nothing raise;
gradients reach B first, then A), then parity with JAX's own adapters
carried across with B != 0 on the tiny Whisper-Flamingo model (every
tower rate 0, gates nonzero): the merged forward's logits, and the
adapter gradients of ``lora_loss_fn(flamingo_loss_fn)`` at atol 2e-6 +
rtol 1e-4 (fp32 sums in other orders, as the Flamingo loss tests). With
the tanh gates at 0 every adapter in ``x_attn`` and in the tower gets an
exactly zero gradient, in JAX too, while the backward still reaches them.
"""

import copy

import numpy as np
import pytest
import torch

import jax

from avsl_tpu.models import lora as jlora
from avsl_tpu.train.objectives import flamingo_loss_fn as jax_loss_fn
from avsl_tpu_torch.models import lora
from avsl_tpu_torch.train import flamingo_loss_fn
from test_torch_flamingo_common import carried_flamingo, one_torch_thread  # noqa: F401
from test_torch_flamingo_loss import _jnp, _torch, make_batch

GRAD_TOL = dict(atol=2e-6, rtol=1e-4)
MIXING = dict(prob_av=1.0, prob_a=0.5)


@pytest.fixture(scope="module")
def carried():
    return carried_flamingo(seed=4)


def jax_adapters(params, rank=4, noise=0.05, seed=3):
    """JAX's adapters over ``params`` with seeded noise on A and B (B != 0)."""
    tree = jlora.init_lora(jax.random.PRNGKey(1), params, rank)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + noise * rng.standard_normal(np.shape(x)).astype(np.float32),
        tree)


def port_inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    mel = rng.normal(size=(2, cfg.n_mels, 100)).astype(np.float32)
    toks = rng.integers(0, cfg.n_vocab, size=(2, 6))
    video = rng.normal(size=(2, 6, 48, 48, 1)).astype(np.float32)
    return mel, toks, video


def test_torch_lora_identity_at_step0_and_structure(carried):
    _, _, port, cfg = carried
    adapters = lora.init_lora(torch.Generator().manual_seed(0), port, rank=4)
    assert adapters and all(p.endswith(("q_proj/kernel", "v_proj/kernel")) for p in adapters)
    s = lora.lora_summary(port, adapters)
    assert s["n_adapters"] == len(adapters) and s["trainable_fraction"] < 0.2
    model = lora.LoraModel(copy.deepcopy(port), adapters, alpha=16.0, rank=4).eval()
    mel, toks, video = (torch.as_tensor(x) for x in port_inputs(cfg))
    with torch.no_grad():
        base = port.eval()(mel, toks, video=video)
        merged = model(mel, toks, video=video)
    assert torch.equal(base, merged)  # B = 0: the merged model is the base
    # the adapters' layout is JAX's: A [in, r] ~ N(0, 1/r), B [r, out] = 0
    a = torch.cat([ab["lora_a"].flatten() for ab in adapters.values()])
    assert abs(float(a.std()) - 0.5) < 0.05
    assert all(not ab["lora_b"].any() for ab in adapters.values())


def test_torch_lora_orphans_and_no_match_raise(carried):
    _, _, port, _ = carried
    orphan = {"wrong/kernel": {"lora_a": torch.ones(8, 2), "lora_b": torch.zeros(2, 8)}}
    with pytest.raises(ValueError, match="no matching base param"):
        lora.merge_lora(port, orphan, alpha=8.0, rank=2)
    with pytest.raises(ValueError, match="no matching base param"):
        lora.LoraModel(copy.deepcopy(port), orphan, alpha=8.0, rank=2)
    with pytest.raises(ValueError, match="no 2-D params matched"):
        lora.init_lora(torch.Generator(), port, rank=2, targets=(r"nothing$",))


def test_torch_lora_gradients_flow_b_then_a(carried):
    """At init (B = 0) dL/dA = G B^T = 0 while dL/dB != 0; once B moves,
    A's gradient turns on."""
    _, _, port, cfg = carried
    model = lora.LoraModel(copy.deepcopy(port), lora.init_lora(
        torch.Generator().manual_seed(0), port, rank=2), alpha=16.0, rank=2).eval()
    mel, toks, video = (torch.as_tensor(x) for x in port_inputs(cfg))

    def grads():
        model.zero_grad()
        (model(mel, toks, video=video) ** 2).mean().backward()
        return ([p.grad for p in model.lora_a.values()], [p.grad for p in model.lora_b.values()])

    ga, gb = grads()
    assert all(not g.any() for g in ga) and any(g.any() for g in gb)
    with torch.no_grad():
        for p, g in zip(model.lora_b.values(), gb):
            p -= 1e-2 * g
    ga2, _ = grads()
    assert any(g.any() for g in ga2)
    assert all(p.grad is None for p in model.base.parameters())


def test_torch_lora_carried_adapters_forward_and_grads_match_jax(carried):
    jmodel, variables, port, cfg = carried
    params = variables["params"]
    tree = jax_adapters(params)
    adapters = lora.lora_from_flax(tree)
    assert lora.lora_to_flax(adapters).keys() == tree.keys()
    model = lora.LoraModel(copy.deepcopy(port), adapters, alpha=8.0, rank=4)
    # the merged forward
    mel, toks, video = port_inputs(cfg, seed=5)
    want = jmodel.apply({"params": jlora.merge_lora(params, tree, 8.0, 4),
                         "batch_stats": variables["batch_stats"]}, mel, toks, video=video)
    with torch.no_grad():
        got = model.eval()(*(torch.as_tensor(x) for x in (mel, toks)), video=torch.as_tensor(video))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)
    # the adapters' gradients through the training loss
    batch = make_batch(cfg, np.random.default_rng(8))
    jwrapped = jlora.lora_loss_fn(jax_loss_fn(jmodel, train=True, **MIXING), params, 8.0, 4)
    want_g = jax.jit(jax.grad(lambda l: jwrapped(l, variables["batch_stats"], _jnp(batch),
                                                 jax.random.PRNGKey(0))[0]))(tree)
    loss, _ = lora.lora_loss_fn(flamingo_loss_fn(model.base, train=True, **MIXING), model)(
        _torch(batch), torch.Generator().manual_seed(0))
    loss.backward()
    want_g = lora.lora_from_flax(jax.device_get(want_g))
    assert sorted(want_g) == sorted(model.lora_a)
    for path, ab in want_g.items():
        for name, table in (("lora_a", model.lora_a), ("lora_b", model.lora_b)):
            np.testing.assert_allclose(table[path].grad.numpy(), ab[name].numpy(),
                                       err_msg=f"{path}/{name}", **GRAD_TOL)


def test_torch_lora_zero_gates_zero_tower_and_x_attn_gradients(carried):
    """Gates at 0 (their initial value): every adapter in ``x_attn`` and in
    the tower gets an exactly zero gradient, as in JAX, though the backward
    reaches them; the text decoder's and the encoder's are nonzero."""
    jmodel, variables, port, cfg = carried
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: np.zeros_like(x) if str(p[-1].key).endswith("_gate") else x,
        variables["params"])
    tree = jax_adapters(params)
    batch = make_batch(cfg, np.random.default_rng(9))
    jwrapped = jlora.lora_loss_fn(jax_loss_fn(jmodel, train=True, **MIXING), params, 8.0, 4)
    want_g = lora.lora_from_flax(jax.device_get(jax.jit(jax.grad(
        lambda l: jwrapped(l, variables["batch_stats"], _jnp(batch), jax.random.PRNGKey(0))[0]))(
        tree)))
    base = copy.deepcopy(port)
    with torch.no_grad():
        for name, p in base.named_parameters():
            if name.endswith("_gate"):
                p.zero_()
    model = lora.LoraModel(base, lora.lora_from_flax(tree), alpha=8.0, rank=4)
    loss, _ = lora.lora_loss_fn(flamingo_loss_fn(base, train=True, **MIXING), model)(
        _torch(batch), torch.Generator().manual_seed(0))
    loss.backward()
    gated = [p for p in model.lora_a if "x_attn" in p or p.startswith("video_model")]
    assert gated and any(p.startswith("video_model") for p in gated)
    for path in model.lora_a:
        for name, table in (("lora_a", model.lora_a), ("lora_b", model.lora_b)):
            grad, want = table[path].grad, want_g[path][name].numpy()
            assert grad is not None, path
            if path in gated:
                assert not grad.any() and not want.any(), path
            else:
                np.testing.assert_allclose(grad.numpy(), want, err_msg=path, **GRAD_TOL)
    assert any(model.lora_b[p].grad.any() for p in model.lora_b if p not in gated)
