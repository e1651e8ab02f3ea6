"""Sequence parallelism through ``avsl_tpu_torch`` (Megatron's, on the model
group) against the JAX package's activation sharding, on the CPU.

The tiny Whisper-Flamingo is carried from JAX (``carried_flamingo``); the
port runs on 2 gloo ranks at dp 1 x mp 2 (``torch_mesh_workers.sp_ranks``,
no ``jax`` in a rank), and the same cases without a mesh in one spawned
process. JAX's cases:

* ``tests/test_partitioning_utils.py:114``: the encoders under the scope
  match the replicated run. Here the Whisper encoder (T = 50) and the
  AV-HuBERT video tower at 6 frames, split over T, and at 5 frames, which
  the model axis does not divide, so the tower's activations stay whole
  (no split is made): features and projected video within 2e-5 of the
  port without a mesh (JAX's bound) and of JAX's encode under its scope
  on its 8-device mesh (the carried models' fp32 bound, 1e-4).
* ``tests/test_sp_scope.py:53``: the step enters the scope itself (the
  loss function sees it on every micro-step, with no caller scope) and
  splits; off (``sequence_parallel=False``) it splits nothing.
* ``:87``: SP on and off give the same losses, within 1e-5 relative in
  fp32 (JAX holds 2e-4), and so does one process, with Whisper dropout,
  the tower's dropout and LayerDrop and SpecAugment on: every draw is made
  at the whole sequence's shape; trained tensors within 1e-6.
* ``:107``: the eval step splits and gives the one-process loss (1e-5).
* ``tests/test_runner.py:165``: the runner's step runs in the scope on a
  model-parallel mesh and not on a data-only one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.core.mesh import activation_sharding_scope as jax_scope
from avsl_tpu.core.mesh import make_mesh as jax_make_mesh
from test_torch_flamingo_common import carried_flamingo, one_torch_thread  # noqa: F401
from test_torch_flamingo_loss import make_batch
from torch_mesh_workers import sp_ranks, spawn

ENCODE_ATOL, JAX_ATOL = 2e-5, 1e-4
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    jmodel, variables, port, cfg = carried_flamingo()
    path = str(tmp / "state.pt")
    torch.save(port.state_dict(), path)
    rng = np.random.default_rng(7)
    mel = rng.normal(size=(2, cfg.n_mels, 100)).astype(np.float32)
    video = rng.normal(size=(2, 6, 48, 48, 1)).astype(np.float32)
    odd = video[:, :5]
    batches = [make_batch(cfg, rng, lead=(2, 4)) for _ in range(2)]
    eval_batch = make_batch(cfg, rng, lead=(4,))
    args = (path, mel, video, odd, batches, eval_batch)
    mesh = spawn(sp_ranks, 2, tmp, *args)
    one = spawn(sp_ranks, 1, tmp, *args)[0]
    jax_mesh = jax_make_mesh(8, model_parallel=2)
    encode = jax.jit(lambda v, m, x: jmodel.apply(v, m, x, method=jmodel.encode))
    with jax_scope(jax_mesh):
        want = {name: tuple(np.asarray(a) for a in encode(variables, jnp.asarray(mel),
                                                          jnp.asarray(v)))
                for name, v in (("even", video), ("odd", odd))}
    return mesh, one, want


@pytest.mark.parametrize("name,splits", [("even", 2), ("odd", 1)])
def test_torch_sp_encoder_matches_replicated(runs, name, splits):
    """Whisper's encoder always splits (T = 50); the tower at 6 frames
    too, at 5 it stays whole."""
    mesh, one, want = runs
    feats, xv, n = mesh[0][f"encode_{name}"]
    assert n == splits
    assert mesh[1][f"encode_{name}"][2] == splits
    for got, ref, jax_ref in zip((feats, xv), one[f"encode_{name}"][:2], want[name]):
        np.testing.assert_allclose(got, ref, rtol=0, atol=ENCODE_ATOL)
        np.testing.assert_allclose(got, jax_ref, rtol=0, atol=JAX_ATOL)
    np.testing.assert_array_equal(mesh[0][f"encode_{name}"][0], mesh[1][f"encode_{name}"][0])


def test_torch_train_step_carries_sp_without_caller_scope(runs):
    mesh, one, _ = runs
    auto = mesh[0]["auto"]
    assert auto["seen"] and all(auto["seen"]) and auto["scatters"] > 0
    # True splits as None does at mp 2 (one step of the two)
    assert mesh[0]["off"]["scatters"] == 0 and 2 * mesh[0]["on"]["scatters"] == auto["scatters"]
    assert mesh[0]["on"]["loss"][0] == auto["loss"][0]
    assert np.all(np.isfinite(auto["loss"]))
    assert one["auto"]["scatters"] == 0 and not any(one["auto"]["seen"])


def test_torch_sp_on_off_losses_match(runs):
    mesh, one, _ = runs
    for r in mesh:  # "auto" is SP on at mp 2
        for key in ("auto", "off"):
            np.testing.assert_allclose(r[key]["loss"], one["auto"]["loss"], rtol=LOSS_RTOL)
        for n, ref in one["auto"]["trained"].items():
            np.testing.assert_allclose(r["auto"]["trained"][n], ref, rtol=0, atol=PARAM_ATOL)
            np.testing.assert_allclose(r["auto"]["trained"][n], r["off"]["trained"][n], rtol=0,
                                       atol=PARAM_ATOL)


def test_torch_eval_step_carries_sp(runs):
    mesh, one, _ = runs
    for r in mesh:
        loss, splits = r["eval"]
        assert splits == 2 and np.isfinite(loss)
        np.testing.assert_allclose(loss, one["eval"][0], rtol=LOSS_RTOL)
    assert one["eval"][1] == 0


def test_torch_runner_enters_sp_scope_on_model_parallel_mesh(runs):
    mesh, _, _ = runs
    for r in mesh:
        assert r["runner"]["mp2"] and all(r["runner"]["mp2"])
        assert r["runner"]["dp2"] and not any(r["runner"]["dp2"])


def test_torch_constrain_activation_drops_what_does_not_split():
    """JAX's ``constrain_activation`` rule (``core/mesh.py:137-155``): no
    scope, a model axis of 1, or an axis that does not divide the dim
    leaves the activation whole; the data axis names rows a rank already
    holds."""
    from types import SimpleNamespace

    from avsl_tpu_torch.core import mesh as mesh_mod
    from avsl_tpu_torch.core.mesh import (
        DATA_AXIS,
        MODEL_AXIS,
        activation_sharding_scope,
        constrain_activation,
    )

    x = torch.randn(2, 6, 4)
    spec = (DATA_AXIS, MODEL_AXIS, None)

    def whole(t):
        y, split = constrain_activation(t, *spec)
        return y is t and split is None

    assert whole(x)
    for dp, mp, t in ((4, 1, 6), (1, 4, 6), (2, 1, 5)):
        mesh = SimpleNamespace(shape={DATA_AXIS: dp, MODEL_AXIS: mp}, model_group=None,
                               model_rank=0)
        with activation_sharding_scope(mesh):
            assert whole(x[:, :t]) and whole(x)
    # the slice the split takes (scatter's collective needs no peer for it)
    scattered = []
    scatter = mesh_mod.SequenceSplit.scatter
    mesh_mod.SequenceSplit.scatter = lambda self, t: scattered.append(self) or t.chunk(
        self.size, self.dim)[self.rank]
    try:
        mesh = SimpleNamespace(shape={DATA_AXIS: 1, MODEL_AXIS: 2}, model_group="g",
                               model_rank=1)
        with activation_sharding_scope(mesh):
            y, split = constrain_activation(x, *spec)
            assert (split.group, split.rank, split.size, split.dim) == ("g", 1, 2, 1)
            assert torch.equal(y, x[:, 3:])
            assert split.draw_split() == (1, 1, 2)
            assert constrain_activation(x, DATA_AXIS, None, MODEL_AXIS)[1].dim == 2
    finally:
        mesh_mod.SequenceSplit.scatter = scatter
    assert len(scattered) == 2
    assert whole(x)
