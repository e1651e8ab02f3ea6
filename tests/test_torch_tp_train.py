"""Tensor parallelism through ``avsl_tpu_torch``: the rule table's
column/row split over the model axis, against the JAX package's
partitioned step on its CPU mesh (fp32, every rate 0).

The tiny Whisper-Flamingo model carried from JAX trains 3 accumulated
steps (as ``test_torch_dp_train.py``, unequal label counts per data rank)
at dp 1 x mp 2 (2 gloo ranks: one attention head per rank, ``fc1``
column- and ``fc2`` row-parallel, the 256-id token embedding
vocab-sharded with its tied logits gathered) and at dp 2 x mp 2 under
FSDP (4 ranks), against ``avsl_tpu.train.make_train_step`` on
``make_mesh(2, model_parallel=2)`` with ``shard_state``. A 257-id
embedding does not divide the model axis and stays whole on every rank;
that run is held to the port's single-device step. Bounds as in
``test_torch_dp_train.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_dp_train import (
    LOSS_RTOL_MESH,
    PARAM_ATOL_MESH,
    assert_matches_jax,
    assert_run_close,
    jax_reference,
    uneven_batches,
)
from test_torch_flamingo_common import carried_flamingo, one_torch_thread  # noqa: F401
from torch_mesh_workers import spawn, tp_fsdp_ranks, tp_ranks, train_flamingo


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    jmodel, variables, port, cfg = carried_flamingo()
    path, path_odd = str(tmp / "state.pt"), str(tmp / "state257.pt")
    state = port.state_dict()
    torch.save(state, path)
    extra = torch.from_numpy(np.random.default_rng(3).normal(0, 0.1, (1, cfg.n_text_state))
                             .astype(np.float32))
    torch.save({**state, "decoder.token_embedding.weight":
                torch.cat([state["decoder.token_embedding.weight"], extra])}, path_odd)
    batches = uneven_batches(cfg)
    return {
        "tp": spawn(tp_ranks, 2, tmp, path, path_odd, batches),
        "tp_fsdp": spawn(tp_fsdp_ranks, 4, tmp, path, batches),
        "single": train_flamingo(path, batches, None),
        "single_odd": train_flamingo(path_odd, batches, None, vocab_size=257),
        "jax": jax_reference(jmodel, variables, batches, n_devices=2, model_parallel=2),
        "initial": {k: v.clone() for k, v in state.items()},
    }


def test_torch_tp_step_matches_jax(runs):
    """dp 1 x mp 2, the vocab-sharded embedding: JAX's partitioned step."""
    for rank in (0, 1):
        got = runs["tp"][rank]["even"]
        assert_run_close(got, runs["single"], LOSS_RTOL_MESH, PARAM_ATOL_MESH)
        assert_matches_jax(got, runs["jax"], runs["initial"])


def test_torch_tp_replicated_embedding(runs):
    """257 ids do not divide the model axis: the embedding stays whole
    (as ``spec_for`` falls back) and the step is the single-device one."""
    for rank in (0, 1):
        sharded = runs["tp"][rank]["sharded"]
        assert "decoder.token_embedding.weight" in sharded[256]
        assert "decoder.token_embedding.weight" not in sharded[257]
        assert set(sharded[256]) - set(sharded[257]) == {"decoder.token_embedding.weight"}
        assert any("x_attn.query" in n for n in sharded[257])
        assert_run_close(runs["tp"][rank]["odd"], runs["single_odd"], LOSS_RTOL_MESH,
                         PARAM_ATOL_MESH)


def test_torch_tp_fsdp_composes(runs):
    """dp 2 x mp 2 with FSDP over the data axis: the same step."""
    for got in runs["tp_fsdp"]:
        assert_run_close(got, runs["single"], LOSS_RTOL_MESH, PARAM_ATOL_MESH)
        assert_matches_jax(got, runs["jax"], runs["initial"])
    assert runs["tp_fsdp"][0]["bytes"] < 0.3 * runs["tp"][0]["even"]["bytes"] * 2
