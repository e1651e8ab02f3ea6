"""Pipeline parallelism of the port (``core/pipeline.py``) against the JAX
package, on gloo ranks on the CPU.

Every case of ``tests/test_pipeline.py``: a stack of 4 fp32 Whisper blocks
(d 16, 2 heads, FF 32) initialised by flax and carried into the port,
``x`` of [8 or 4, 6, 16] from numpy seeds.

* The forward at (stages, microbatches) = (2, 2), (4, 4) and (2, 4)
  against JAX's ``pipeline_apply`` on its 8-device mesh and the
  sequential stack, within 1e-5 (JAX's tolerance), on every stage rank.
* The gradients of the stacked tensors (each stage rank's rows, summed;
  every other row zero) and of ``x`` under ``mean(y ** 2)`` at 2 stages
  and 2 microbatches, against ``jax.grad`` of the unpipelined stack
  (rtol 1e-4, atol 1e-6; JAX's own tests hold its pipeline to that).
* Data 2 x stage 2 on 4 ranks (JAX's case is 2 x 4 on 8 devices), each
  data rank on its rows.
* Per-example attention masks riding in ``extras``: the masked
  sequential run's output, which differs from the unmasked one.
* The stack/unstack round trip and the "not divisible" errors, with
  JAX's shapes (4 layers on 3 stages, a batch of 4 in 3 microbatches, 3
  devices in stages of 2).
* Added for the port's design: the gradient of ``x`` is bit-identical on
  every stage rank (stage 0's, broadcast).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsl_tpu.core.pipeline import make_pp_mesh as jax_make_pp_mesh
from avsl_tpu.core.pipeline import pipeline_apply as jax_pipeline_apply
from avsl_tpu.core.pipeline import stack_block_params as jax_stack_block_params
from avsl_tpu.models.layers import TransformerBlock as JaxBlock
from avsl_tpu_torch.core.pipeline import (
    make_pp_mesh,
    pipeline_apply,
    stack_block_params,
    unstack_block_params,
)
from avsl_tpu_torch.models.convert import flax_path_to_torch_key, state_dict_from_flax
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)
from torch_mesh_workers import pp_schedule_ranks, pp_stack, spawn

L, D, H, FF, T = 4, 16, 2, 32, 6
FORWARD = [(2, 2), (4, 4), (2, 4)]
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _jax_block():
    return JaxBlock(d_model=D, n_heads=H, d_ff=FF, dtype=jnp.float32, param_dtype=jnp.float32)


def _jax_stack(seed: int):
    """JAX's ``_stacked_params``: L blocks named ``block_i`` under one parent."""
    import flax.linen as nn

    class Stack(nn.Module):
        @nn.compact
        def __call__(self, x):
            for i in range(L):
                x, _ = JaxBlock(d_model=D, n_heads=H, d_ff=FF, dtype=jnp.float32,
                                param_dtype=jnp.float32, name=f"block_{i}")(x)
            return x

    model = Stack()
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((2, T, D), jnp.float32))["params"]
    return model, params


def _port_stacked(params) -> dict:
    """Flax ``block_i`` subtrees -> the port's ``[L, ...]`` arrays by key."""
    per_layer = [state_dict_from_flax(
        params[f"block_{i}"],
        key_fn=lambda p: flax_path_to_torch_key("encoder/block_0/" + p)[len("encoder.blocks.0."):])
        for i in range(L)]
    return {k: np.stack([layer[k].numpy() for layer in per_layer]) for k in per_layer[0]}


def _jax_block_fn(lp, h, extras):
    mask = None if extras is None else extras.get("mask")
    out, _ = _jax_block().apply({"params": lp}, h, None, None, mask)
    return out


@pytest.fixture(scope="module")
def cases(eight_devices):
    """The port's ranks (one spawn of 2 ranks and one of 4, run while JAX
    computes its references) and JAX's references."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    stacks = {seed: _jax_stack(seed) for seed in range(4)}
    xs = {seed: np.random.default_rng(seed).normal(size=(8 if seed in (0, 2) else 4, T, D))
          .astype(np.float32) for seed in range(4)}
    mask = np.ones((4, 1, T, T), bool)
    mask[2:, :, :, T // 2:] = False  # rows 2 and 3 attend to the first half only
    two, four, where = [], [], {}

    def add(name, seed, stages, micro, world, **kw):  # a case for the ranks of a world size
        where[name] = (world is two, len(world))
        world.append(dict(stages=stages, micro=micro, stacked=_port_stacked(stacks[seed][1]),
                          heads=H, x=xs[seed], **kw))

    for stages, micro in FORWARD:
        add(("fwd", stages, micro), 0, stages, micro, two if stages == 2 else four)
    add("grad", 1, 2, 2, two, grad=True)
    add("dp", 2, 2, 2, four)
    add("mask", 3, 2, 2, two, mask=mask)

    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(2) as pool:
        ranks2 = pool.submit(spawn, pp_schedule_ranks, 2, tmp, two)
        ranks4 = pool.submit(spawn, pp_schedule_ranks, 4, tmp, four)
        want = {}
        model, params = stacks[0]
        sequential = np.asarray(model.apply({"params": params}, xs[0]))
        stacked, _ = jax_stack_block_params(params, L)
        for stages, micro in FORWARD:
            mesh = jax_make_pp_mesh(stages, stages=stages, devices=eight_devices)
            got = jax_pipeline_apply(_jax_block_fn, stacked, jnp.asarray(xs[0]), mesh=mesh,
                                     n_microbatches=micro)
            want[("fwd", stages, micro)] = (np.asarray(got), sequential)

        model, params = stacks[1]

        def loss_seq(p, xx):
            return jnp.mean(model.apply({"params": p}, xx) ** 2)

        g_p, g_x = jax.grad(loss_seq, argnums=(0, 1))(params, jnp.asarray(xs[1]))
        want["grad"] = (_port_stacked(g_p), np.asarray(g_x))
        model, params = stacks[2]
        want["dp"] = np.asarray(model.apply({"params": params}, xs[2]))
        model, params = stacks[3]
        h = jnp.asarray(xs[3])
        for i in range(L):
            h = _jax_block_fn(params[f"block_{i}"], h, {"mask": jnp.asarray(mask)})
        want["mask"] = (np.asarray(h), np.asarray(model.apply({"params": params}, xs[3])))
        ranks2, ranks4 = ranks2.result(), ranks4.result()
    got = {name: [r[i] for r in (ranks2 if in_two else ranks4)]
           for name, (in_two, i) in where.items()}
    return want, got


@pytest.mark.parametrize("stages,micro", FORWARD)
def test_torch_pp_forward_matches_sequential(cases, stages, micro):
    want, got = cases
    jax_pp, sequential = want[("fwd", stages, micro)]
    np.testing.assert_allclose(jax_pp, sequential, **FWD_TOL)
    assert len(got[("fwd", stages, micro)]) == stages
    for rec in got[("fwd", stages, micro)]:
        np.testing.assert_allclose(rec["y"], jax_pp, **FWD_TOL,
                                   err_msg=f"stage rank {rec['stage_rank']}")


def test_torch_pp_grads_match_sequential(cases):
    """Each stage rank's rows of the stacked gradients, summed over the
    stage ranks, and the gradient of x, against JAX's unpipelined grad."""
    want, got = cases
    g_p, g_x = want["grad"]
    ranks = got["grad"]
    per = L // 2
    for key, g in g_p.items():
        total = sum(r["grads"][key] for r in ranks)
        np.testing.assert_allclose(total, g, **GRAD_TOL, err_msg=key)
        for r in ranks:  # a stage's gradient touches its own layers only
            s = r["stage_rank"]
            outside = np.delete(r["grads"][key], np.s_[s * per:(s + 1) * per], axis=0)
            assert not outside.any(), (key, s)
    for r in ranks:
        np.testing.assert_allclose(r["gx"], g_x, **GRAD_TOL, err_msg=f"x, stage {r['stage_rank']}")


def test_torch_pp_grad_x_identical_on_every_stage_rank(cases):
    _, got = cases
    first, *others = got["grad"]
    for r in others:
        np.testing.assert_array_equal(r["gx"], first["gx"])
        np.testing.assert_array_equal(r["y"], first["y"])


def test_torch_pp_composes_with_data_parallel(cases):
    """data 2 x stage 2: each data rank's rows through its pipeline."""
    want, got = cases
    assert sorted((r["data_rank"], r["stage_rank"]) for r in got["dp"]) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in got["dp"]:
        rows = want["dp"][4 * r["data_rank"]:4 * (r["data_rank"] + 1)]
        np.testing.assert_allclose(r["y"], rows, **FWD_TOL, err_msg=str(r["data_rank"]))


def test_torch_pp_extras_ride_with_microbatches(cases):
    want, got = cases
    masked, unmasked = want["mask"]
    for r in got["mask"]:
        np.testing.assert_allclose(r["y"], masked, **FWD_TOL)
        assert not np.allclose(r["y"], unmasked, atol=1e-3)


def test_torch_pp_stack_unstack_roundtrip():
    _, params = _jax_stack(4)
    blocks = {f"block_{i}": {k: torch.from_numpy(v[i].copy())
                             for k, v in _port_stacked(params).items()} for i in range(L)}
    nested = {name: {} for name in blocks}
    for name, flat in blocks.items():  # "attn.query.weight" -> nested dicts
        for key, t in flat.items():
            node = nested[name]
            *path, leaf = key.split(".")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = t
    stacked, rest = stack_block_params(nested, L)
    assert rest == {}
    assert stacked["attn"]["query"]["weight"].shape == (L, D, D)
    back = unstack_block_params(stacked, L)
    assert back.keys() == nested.keys()
    for name in nested:
        for key, t in blocks[name].items():
            node = back[name]
            for p in key.split("."):
                node = node[p]
            torch.testing.assert_close(node, t, rtol=0, atol=0)
    with pytest.raises(KeyError):
        stack_block_params(nested, L + 1)
    with pytest.raises(KeyError):
        unstack_block_params(stacked, L + 1)


def test_torch_pp_rejects_bad_shapes():
    """JAX's shapes: 4 layers on 3 stages, a batch of 4 in 3
    microbatches; both refused before any transfer."""
    _, params = _jax_stack(5)
    blocks = pp_stack(_port_stacked(params), H)
    x = torch.zeros((4, T, D))

    def mesh(stages):  # the shape and coordinate pipeline_apply reads first
        return types.SimpleNamespace(shape={"data": 1, "stage": stages}, stage_rank=0,
                                     stage_group=None)

    with pytest.raises(ValueError, match="not divisible"):
        pipeline_apply(blocks.block_fn, blocks, x, mesh=mesh(3), n_microbatches=2)
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_apply(blocks.block_fn, blocks, x, mesh=mesh(2), n_microbatches=3)
    with pytest.raises(ValueError, match="not divisible"):
        make_pp_mesh(3, stages=2)
