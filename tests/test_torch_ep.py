"""Expert parallelism and the global MoE routing of the port (CPU, gloo).

* The expert-parallel block: JAX's ``tests/test_moe.py:233`` case (a
  ``TransformerBlock`` of d 16, 2 heads, F 32, 4 experts of top 2, fp32,
  on a [4, 8, 16] batch; ``sum(y^2) + 0.01 aux``), its parameters carried
  into the port with noise on every leaf, at the JAX case's capacity
  factor 1.25 and at 0.5, where capacity binds (a dozen tokens lose a
  slot). On (data 1, expert 2), (data 2, expert 1) and (data 2, expert 2)
  each rank runs its rows as the train step does; the loss and every
  gradient (the expert leaves gathered whole) equal one process within
  1e-6 relative (atol 1e-7) and JAX's one-device value within 1e-4
  (atol 1e-5 + rtol 1e-4). A gradient element sums over every token, so
  its atol is the relative tolerance times its tensor's largest element
  where that is larger.
* Global routing: at (data 2, expert 1) and capacity factor 0.5 each
  rank's dispatch tensor is its rows of one device's, exactly, while a
  rank-local routing of the same rows differs (so a port that routed per
  rank would fail), and ``moe_aux`` is one device's within 1e-6; with
  two row blocks a rank (the frozen-tower hoist's flattened
  micro-batches, each split over the ranks) the slots are one device's
  too.
* The state at (data 2, expert 2) with ZeRO-1 on 4 ranks: the expert
  leaves split over the expert axis, their moments' free dim over data;
  losses, grad norms and trained tensors against one process; the
  checkpoint's logical state restored through ``restore_sharded``.
* The rule table against ``tests/test_moe.py:132`` (an (data, expert)
  mesh of 2 x 4, and (data, expert, model) of 2 x 2 x 2), read from JAX's
  ``spec_for`` on JAX's meshes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from avsl_tpu.core.partitioning import spec_for as jax_spec_for
from avsl_tpu.models.layers import TransformerBlock as JaxBlock
from avsl_tpu.models.moe import make_ep_mesh as jax_make_ep_mesh
from avsl_tpu.models.moe import moe_aux_loss as jax_moe_aux_loss
from avsl_tpu_torch.core.partitioning import P, spec_for
from avsl_tpu_torch.models.convert import flax_path_to_torch_key, state_dict_from_flax
from avsl_tpu_torch.models.intermediates import collect_intermediates
from avsl_tpu_torch.models.moe import moe_aux_loss
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)
from torch_mesh_workers import ep_block_ranks, load_moe_block, moe_block_step, spawn

CAPACITY = (1.25, 0.5)
ONE_PROCESS = dict(rtol=1e-6, atol=1e-7)
AGAINST_JAX = dict(rtol=1e-4, atol=1e-5)


def _block_key(path: str) -> str:
    return flax_path_to_torch_key("encoder/block_0/" + path)[len("encoder.blocks.0."):]


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Per capacity factor: JAX's loss, aux and gradients (as port state
    dicts), the port's one-process values, and the carried state's path;
    plus the batch."""
    tmp = tmp_path_factory.mktemp("ep")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 8, 16)).astype(np.float32)
    out = {}
    for cf in CAPACITY:
        block = JaxBlock(d_model=16, n_heads=2, d_ff=32, n_experts=4, moe_top_k=2,
                         moe_capacity_factor=cf, dtype=jnp.float32)
        params = block.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
        noise = np.random.default_rng(7)
        params = jax.tree_util.tree_map(
            lambda p: p + 0.05 * noise.normal(size=p.shape).astype(np.float32), params)

        def loss(p):
            (y, _), state = block.apply({"params": p}, jnp.asarray(x), mutable=["intermediates"])
            aux = jax_moe_aux_loss(state["intermediates"])
            return jnp.sum(y ** 2) + 0.01 * aux, aux

        (want_l, want_aux), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        sd = state_dict_from_flax(params, key_fn=_block_key)
        path = str(tmp / f"block_{cf}.pt")
        torch.save(sd, path)
        port = load_moe_block(path, cf)
        assert sorted(port.state_dict()) == sorted(sd)
        one = moe_block_step(port, x, None)
        with torch.no_grad(), collect_intermediates() as inter:
            load_moe_block(path, cf)(torch.as_tensor(x))
        route = load_moe_block(path, cf).mlp.route(torch.as_tensor(x))
        out[cf] = {"jax": (float(want_l), float(want_aux),
                           {k: v.numpy() for k, v in
                            state_dict_from_flax(want_g, key_fn=_block_key).items()}),
                   "one": one, "path": path, "aux": float(moe_aux_loss(inter)),
                   "dispatch": route.dispatch.numpy()}
    return x, out


def _check(got, want, tol, what):
    loss, aux, grads = got
    w_loss, w_aux, w_grads = want
    np.testing.assert_allclose(loss, w_loss, **tol, err_msg=f"{what} loss")
    np.testing.assert_allclose(aux, w_aux, **tol, err_msg=f"{what} aux")
    assert sorted(grads) == sorted(w_grads)
    for name, g in w_grads.items():
        # a gradient element sums over every token: its rounding goes with
        # its tensor's largest element
        atol = max(tol["atol"], tol["rtol"] * float(np.abs(g).max()))
        np.testing.assert_allclose(grads[name], g, rtol=tol["rtol"], atol=atol,
                                   err_msg=f"{what} {name}")


def test_torch_ep_one_process_matches_jax(cases):
    """The port's block alone against JAX, and capacity binding at 0.5."""
    x, out = cases
    for cf, case in out.items():
        _check(case["one"], case["jax"], AGAINST_JAX, f"cf {cf}")
        kept = case["dispatch"].sum()
        # 4 x 8 tokens, 2 choices each: every slot kept at 1.25, a dozen lost at 0.5
        assert (kept == 64) if cf == 1.25 else (kept < 56), (cf, kept)


@pytest.mark.parametrize("world,meshes", [(2, [(1, 2), (2, 1)]), (4, [(2, 2)])],
                         ids=["world2", "world4"])
def test_torch_ep_block_matches_one_process_and_jax(cases, tmp_path, world, meshes):
    x, out = cases
    ranks = spawn(ep_block_ranks, world, tmp_path, {cf: c["path"] for cf, c in out.items()},
                  x, meshes)
    for r, got in enumerate(ranks):
        for dp, ep in meshes:
            for cf, case in out.items():
                what = f"rank {r} data {dp} expert {ep} cf {cf}"
                _check(got[(dp, ep, cf)], case["one"], ONE_PROCESS, what)
                _check(got[(dp, ep, cf)], case["jax"], AGAINST_JAX, what + " vs JAX")
    if world == 2:
        for cf, case in out.items():
            routed = np.concatenate([got[("dispatch", cf)][0] for got in ranks])
            alone = np.concatenate([got[("dispatch", cf)][1] for got in ranks])
            np.testing.assert_array_equal(routed, case["dispatch"])
            if cf == 0.5:  # capacity binds: a rank-local routing keeps other tokens
                assert not np.array_equal(alone.sum(-1), case["dispatch"].sum(-1))
            # row blocks: rank r's rows r and 2 + r, in one device's order
            tokens = case["dispatch"].reshape(4, 8, *case["dispatch"].shape[1:])
            for r, got in enumerate(ranks):
                want = tokens[[r, 2 + r]].reshape(16, *tokens.shape[2:])
                np.testing.assert_array_equal(got[("dispatch", cf)][2], want)
            np.testing.assert_allclose(ranks[0][(2, 1, cf)][1], case["aux"], **ONE_PROCESS)


def test_torch_expert_partitioning_rules():
    """``tests/test_moe.py:132`` on the port's ``spec_for``, each spec read
    from JAX's on JAX's mesh of the same shape."""
    from types import SimpleNamespace

    devices = np.array(jax.devices()[:8])
    ep = jax_make_ep_mesh(8, experts_parallel=4)
    mesh3 = JaxMesh(devices.reshape(2, 2, 2), ("data", "expert", "model"))
    port_ep = SimpleNamespace(shape={"data": 2, "expert": 4})
    port3 = SimpleNamespace(shape={"data": 2, "expert": 2, "model": 2})
    cases = [("enc/layer_0/mlp/w_in", (4, 16, 32), ep, port_ep),
             ("enc/layer_0/mlp/w_out", (4, 32, 16), ep, port_ep),
             ("enc/layer_0/mlp/b_in", (4, 32), ep, port_ep),
             ("enc/layer_0/mlp/router", (16, 4), ep, port_ep),
             ("x/mlp/w_in", (2, 16, 32), mesh3, port3),
             ("x/mlp/w_out", (2, 32, 16), mesh3, port3),
             ("x/mlp/w_in", (3, 16, 32), mesh3, port3)]
    for path, shape, jmesh, pmesh in cases:
        assert tuple(spec_for(path, shape, pmesh)) == tuple(jax_spec_for(path, shape, jmesh)), path
    assert spec_for("enc/layer_0/mlp/w_in", (4, 16, 32), port_ep) == P("expert", None, None)
    assert spec_for("x/mlp/w_in", (3, 16, 32), port3) == P(None, None, "model")


def test_torch_ep_state_zero1_and_checkpoints(tmp_path):
    """(data 2, expert 2) with ZeRO-1 on 4 ranks, the tiny CTC AV-HuBERT
    with 2 experts trained 2 steps: each rank holds one expert of
    ``w_in`` [2, 32, 64] and its moments split the free dim over data
    ([1, 16, 64]); the losses and grad norms (the global norm sums each
    expert leaf over the expert group and counts replicated leaves once)
    equal one process's within 1e-6 relative, the trained tensors within
    1e-6 (the key biases, whose gradient is rounding noise, within 3
    learning rates); the checkpoint holds the logical state, and
    ``restore_sharded`` brings it back bit for bit on the same mesh and
    without a mesh."""
    from avsl_tpu_torch.cli.avhubert_ft import collate_av, make_synthetic_av_batchset
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.models import build_avhubert
    from torch_mesh_workers import AVH_TP_CFG, ep_state_ranks, train_avhubert

    cfg = AVHuBERTConfig.tiny_test(**AVH_TP_CFG)
    rows = make_synthetic_av_batchset(8, image=24, vocab=cfg.vocab_size, seed=6)
    batches = [collate_av(rows[i:i + 4], cfg.pad_token_id) for i in (0, 4)]
    path = str(tmp_path / "ctc.pt")
    torch.save(build_avhubert(cfg, "ctc", device="cpu", seed=3).state_dict(), path)
    ranks = spawn(ep_state_ranks, 4, tmp_path, path, batches, str(tmp_path / "ckpt"))
    single = train_avhubert("ctc", path, batches, None)
    for r, got in enumerate(ranks):
        assert got["tp_dim"] == 0 and got["zero_dim"] == 1
        assert got["w_in_local"] == (1, 32, 64) and got["w_in_mu"] == (1, 16, 64)
        np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-6, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["grad_norm"], single["grad_norm"], rtol=1e-6)
        for name, want in single["params"].items():
            atol = 3e-3 if name.endswith("k_proj.bias") else 1e-6
            np.testing.assert_allclose(got["params"][name], want, atol=atol, rtol=0,
                                       err_msg=f"rank {r} {name}")
        assert got["same_mesh"] and got["no_mesh"]
