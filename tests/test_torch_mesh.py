"""The mesh layer of the port (CPU): the rule table against the JAX
package's, batches and row draws on a mesh, the refusals of what is not
ported, and ``cli.finetune`` under ``torch.distributed.run``.

* ``spec_for``, ``_add_data_axis`` and ``state_shardings``: JAX's cases
  (``test_partitioning_utils.py:45``, ``test_zero1.py:59``,
  ``test_fsdp.py:58``), and every parameter of the tiny Whisper-Flamingo
  model, whose port spec must be the transpose of JAX's ``spec_for`` on
  its flax path (and under ZeRO-1/FSDP of ``_add_data_axis``'s) on
  (data, model) = (1, 2), (2, 1) and (4, 2);
* ``shard_batch`` with scalars and a partial batch
  (``test_partitioning_utils.py:157``);
* row draws: under ``row_shard_scope`` each rank's dropout mask is its
  rows of the single-device mask, so masks differ across data ranks, each
  at the rate within 5 sigma, while LayerDrop's draw agrees on every rank;
* one test per refusal (sequence parallelism, the serving mesh,
  ``num_devices`` against the world size), and the meshes of the
  AV-HuBERT/pretraining flags (on 2 spawned ranks) and an MoE tower put on
  a data axis and on an expert axis;
* ``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
  avsl_tpu_torch.cli.finetune cfg.yaml --smoke --device cpu`` with
  ``num_devices: 2`` (with ZeRO-1, then ``model_parallel: 2`` with FSDP):
  rc 0, and only rank 0 writes (one ``done:`` line, one metrics line per
  logged step, the checkpoints).
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as JaxP

import avsl_tpu.core.partitioning as jax_part
import avsl_tpu_torch.core.partitioning as part
from avsl_tpu.core.mesh import make_mesh as jax_make_mesh
from avsl_tpu.core.tree import path_str as jax_path_str
from avsl_tpu_torch.core.mesh import (
    RowShard,
    data_sharding,
    draw_rows,
    local_batch_size,
    make_mesh,
    replicated_sharding,
    row_shard_scope,
    shard_batch,
)
from avsl_tpu_torch.core.partitioning import (
    P,
    _add_data_axis,
    spec_for,
    state_shardings,
    torch_spec,
)
from avsl_tpu_torch.core.tree import flax_dims, path_str
from avsl_tpu_torch.models.convert import flax_path_to_torch_key
from avsl_tpu_torch.models.layers import residual_dropout
from test_torch_flamingo_common import carried_flamingo, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fake_mesh(dp, mp, data_rank=0):
    return SimpleNamespace(shape={"data": dp, "model": mp}, data_rank=data_rank,
                           model_rank=0, device=torch.device("cpu"))


@pytest.fixture(scope="module")
def carried():
    return carried_flamingo()


def test_torch_spec_for_rules_and_fallbacks():
    """``test_partitioning_utils.py:45``'s cases."""
    mesh = fake_mesh(4, 2)
    assert spec_for("decoder/block_0/mlp/fc1/kernel", (64, 128), mesh) == P(None, "model")
    assert spec_for("decoder/block_0/mlp/fc2/kernel", (128, 64), mesh) == P("model", None)
    assert spec_for("encoder/block_1/self_attn/q_proj/kernel", (64, 64), mesh) == P(None, "model")
    assert spec_for("encoder/block_1/self_attn/out_proj/kernel", (64, 64), mesh) == P("model", None)
    assert spec_for("decoder/token_embedding/embedding", (256, 64), mesh) == P("model", None)
    assert spec_for("encoder/conv1/kernel", (3, 80, 64), mesh) == P()
    assert spec_for("x/mlp/fc1/kernel", (64, 65), mesh) == P()
    assert spec_for("x/mlp/fc1/kernel", (64, 128), fake_mesh(8, 1)) == P()
    # large-v2's 51,865 ids replicate on any model axis
    assert spec_for("decoder/token_embedding/embedding", (51865, 1280), fake_mesh(2, 4)) == P()


def test_torch_add_data_axis_and_state_shardings(carried):
    """``test_zero1.py:59``'s composition cases, and the port's
    ``state_shardings``: Adam moments mirror their parameter, ZeRO-1 adds
    the data axis to the moments only, FSDP to the parameters too."""
    mesh = fake_mesh(4, 2)
    assert _add_data_axis(P(None, "model"), (512, 64), mesh) == P("data", "model")
    assert _add_data_axis(P("model", None), (64, 512), mesh) == P("model", "data")
    assert _add_data_axis(P(), (7, 9), mesh) == P()
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.train import TrainState, select_optimizer

    port = carried[2]
    opt, _ = select_optimizer(port, FlamingoTrainConfig(add_gated_x_attn=1), 10)
    state = TrainState.create(port, opt)
    name = "decoder.blocks.0.x_attn.query.weight"  # [64, 64]: flax kernel [in, out]
    plain = state_shardings(state, fake_mesh(2, 2))
    assert plain["params"][name] == P("model", None) == plain["opt_state"][name]
    old = part.ZERO1_MIN_ELEMS
    part.ZERO1_MIN_ELEMS = 1024
    try:
        z1 = state_shardings(state, fake_mesh(2, 2), zero1=True)
        fs = state_shardings(state, fake_mesh(2, 2), fsdp=True)
    finally:
        part.ZERO1_MIN_ELEMS = old
    assert z1["params"][name] == P("model", None) and z1["opt_state"][name] == P("model", "data")
    assert fs["params"][name] == P("model", "data") == fs["opt_state"][name]
    assert set(plain["opt_state"]) == set(opt.names)


@pytest.mark.parametrize("dp,mp", [(1, 2), (2, 1), (4, 2)])
@pytest.mark.parametrize("data_axis", [False, True])
def test_torch_port_spec_is_jax_spec_transposed(carried, monkeypatch, dp, mp, data_axis):
    """Every parameter of the tiny Whisper-Flamingo: the port's spec on its
    torch tensor is JAX's ``spec_for`` (with ``_add_data_axis`` under
    ZeRO-1/FSDP) on its flax path, moved through the layout's transpose."""
    monkeypatch.setattr(jax_part, "ZERO1_MIN_ELEMS", 1024)
    monkeypatch.setattr(part, "ZERO1_MIN_ELEMS", 1024)
    _, variables, port, _ = carried
    jmesh = jax_make_mesh(dp * mp, model_parallel=mp)
    shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    checked = sharded = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(variables["params"])[0]:
        flax = jax_path_str(path)
        assert path_str(path) == flax
        want = jax_part.spec_for(flax, leaf.shape, jmesh)
        if data_axis and leaf.size >= 1024:
            want = jax_part._add_data_axis(want, leaf.shape, jmesh)
        key = flax_path_to_torch_key(flax)
        got = torch_spec(key, shapes[key], fake_mesh(dp, mp), data_axis=data_axis)
        padded = list(want) + [None] * (len(shapes[key]) - len(want))
        transposed = [padded[i] for i in flax_dims(key, len(shapes[key]))]
        expect = P() if want == JaxP() else P(*transposed)
        assert got == expect, (flax, key, want, got)
        checked += 1
        sharded += got != P()
    assert checked == len(jax.tree_util.tree_leaves(variables["params"])) > 100
    assert sharded > 20 if (mp > 1 or data_axis) else sharded == 0


def test_torch_memory_and_paths_utils(tmp_path):
    """``test_partitioning_utils.py``'s cases of ``utils/paths.py`` and
    ``utils/memory.py``: directories, the disk report, the memory stats
    (no device entries on the CPU), the parameter estimate and the batch
    clamp (the request without a card)."""
    from avsl_tpu_torch.utils.memory import (
        estimate_model_memory,
        get_memory_stats,
        memory_aware_batch_size,
    )
    from avsl_tpu_torch.utils.paths import check_writable, disk_usage_report, ensure_dir

    d = ensure_dir(str(tmp_path / "a" / "b"))
    assert os.path.isdir(d) and check_writable(d)
    assert not check_writable("/proc/definitely_not_writable_dir_xyz")
    rep = disk_usage_report(str(tmp_path))
    assert rep["total_gb"] > 0 and 0 <= rep["used_pct"] <= 100
    stats = get_memory_stats()
    assert stats["system_total_gb"] > 0
    est = estimate_model_memory(torch.nn.Linear(1000, 1000, bias=False))
    assert est["n_params"] == 1_000_000 and est["total_gb_est"] > est["params_gb"]
    assert memory_aware_batch_size(16, per_item_gb=0.001) >= 1


def test_torch_shard_batch_tolerates_scalars_and_partial_batches():
    """``test_partitioning_utils.py:157``: a leaf that divides the data
    axis is cut, a partial one and a scalar are given whole."""
    batch = {"x": np.arange(24, dtype=np.float32).reshape(8, 3),
             "tail": np.ones((5, 3), np.float32), "epoch": np.float32(2.0)}
    out = shard_batch(fake_mesh(4, 2, data_rank=2), batch)
    assert out.sharded == frozenset({"x"})
    np.testing.assert_array_equal(out["x"].numpy(), batch["x"][4:6])
    assert out["tail"].shape == (5, 3) and float(out["epoch"]) == 2.0
    acc = shard_batch(fake_mesh(2, 1, data_rank=1), {"y": np.zeros((2, 4, 3))}, batch_dim=1)
    assert acc["y"].shape == (2, 2, 3) and acc.batch_dim == 1
    mesh = fake_mesh(4, 2)
    assert data_sharding(mesh, 3) == P("data", None, None) and data_sharding(mesh, 0) == P()
    assert replicated_sharding(mesh) == P() and local_batch_size(8, mesh) == 2
    with pytest.raises(ValueError, match="not divisible"):
        local_batch_size(6, mesh)


def test_torch_row_draws_are_the_global_draws():
    """Each data rank's draw is its rows of the draw at the global shape
    from the same seed (so ranks draw different rows and every generator
    stays in step); a model-axis split keeps its slice of that dim; the
    grouped layout of the hoist takes its rows of each group."""
    def draw(shape, seed=0, **kw):
        gen = torch.Generator().manual_seed(seed)
        return draw_rows(lambda s: torch.rand(s, generator=gen), shape, **kw), gen

    whole, g_whole = draw((8, 3, 5))
    parts = []
    for r in range(2):
        with row_shard_scope(RowShard(None, r, 2)):
            part_r, g_r = draw((4, 3, 5))
        parts.append(part_r)
        assert torch.equal(g_r.get_state(), g_whole.get_state())
    assert torch.equal(torch.cat(parts), whole)
    head = [draw((8, 1, 5), split=(1, m, 3))[0] for m in range(3)]
    assert torch.equal(torch.cat(head, 1), whole)
    with row_shard_scope(RowShard(None, 1, 2, groups=2)):
        grouped, _ = draw((4, 3, 5))
    np.testing.assert_array_equal(grouped.numpy(),
                                  whole.reshape(2, 4, 3, 5)[:, 2:].reshape(4, 3, 5).numpy())


def test_torch_layerdrop_agrees_and_dropout_differs_across_data_ranks():
    """The tower's LayerDrop (one draw a layer) picks the same layers on
    both data ranks over 100 forwards, while their dropout masks differ;
    each rank's dropped share is the rate within 5 sigma."""
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.models.avhubert import AVHuBERTTransformerEncoder
    from test_torch_flamingo_common import ZERO_RATES

    cfg = AVHuBERTConfig.tiny_test(dtype="float32", **{**ZERO_RATES, "layerdrop": 0.5},
                                   num_hidden_layers=1)
    enc = AVHuBERTTransformerEncoder(cfg)
    init = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in enc.parameters():
            p.normal_(0.0, 0.2, generator=init)
        x = torch.randn(4, 9, cfg.hidden_size, generator=init)
        enc.train()
        picks = []
        for r in range(2):
            gen = torch.Generator().manual_seed(5)
            rows = x[2 * r:2 * r + 2]
            dropped = rows + enc.pos_conv(rows)
            with row_shard_scope(RowShard(None, r, 2)):
                picks.append([torch.equal(enc(rows, output_layer=1, generator=gen), dropped)
                              for _ in range(100)])
    assert picks[0] == picks[1] and 20 < sum(picks[0]) < 80
    masks = []
    for r in range(2):
        gen = torch.Generator().manual_seed(5)
        with row_shard_scope(RowShard(None, r, 2)):
            masks.append(residual_dropout(torch.ones(8, 4096), 0.3, True, gen) == 0)
    assert not torch.equal(masks[0], masks[1])
    for m in masks:  # 32768 cells at rate 0.3: 5 sigma = 0.0127
        assert abs(m.float().mean().item() - 0.3) < 0.0127


def test_torch_sequence_parallel_raises():
    """Sequence parallelism is ported (it raised before): the steps build
    with it on, and JAX's rule decides the scope (``train/loop.py:33-49``):
    None turns it on for a model axis above 1 only, False never."""
    from avsl_tpu_torch.core import mesh as mesh_mod
    from avsl_tpu_torch.train import make_eval_step, make_train_step
    from avsl_tpu_torch.train.loop import sp_scope

    make_train_step(lambda b, g: None, sequence_parallel=True)
    make_eval_step(lambda b, g: None, sequence_parallel=True)
    for mesh, sp, on in ((fake_mesh(2, 2), None, True), (fake_mesh(4, 1), None, False),
                         (fake_mesh(2, 2), False, False), (fake_mesh(4, 1), True, True),
                         (None, None, False)):
        with sp_scope(mesh, sp):
            assert (mesh_mod._ACTIVATION_MESH[0] is not None) == on
    assert mesh_mod._ACTIVATION_MESH[0] is None


def test_torch_serving_mesh_raises(carried):
    """The serving mesh is ported: outside the launcher the CLIs' mesh
    raises, and the transcriber refuses int8 weights on a mesh and a batch
    the data axis does not divide (JAX's ``tests/test_infer.py:207``)."""
    from avsl_tpu_torch.cli._serving_common import serving_mesh
    from avsl_tpu_torch.data.tokenizer import ByteTokenizer
    from avsl_tpu_torch.infer import StreamingTranscriber

    assert serving_mesh(SimpleNamespace(model_parallel=1, data_parallel=1)) is None
    model = carried[2]
    with pytest.raises(ValueError, match="quantize"):
        StreamingTranscriber(model, ByteTokenizer(), quantize="int8", mesh=fake_mesh(1, 2))
    with pytest.raises(ValueError, match="not divisible"):
        StreamingTranscriber(model, ByteTokenizer(), batch_size=3, mesh=fake_mesh(2, 1))


def test_torch_expert_parallel_and_avhubert_mesh_flags_raise(tmp_path):
    """The flags build JAX's meshes (``avhubert_ft.py:212-236``): on 2
    ranks ``make_ep_mesh`` gives (data 1, expert 2) or (data 2, expert 1),
    ``--experts_parallel`` wins beside ``--model_parallel``, flags of 1
    give no mesh; JAX's one refusal, an axis that does not divide the
    devices, stays."""
    from torch_mesh_workers import mesh_flag_ranks, spawn

    for out in spawn(mesh_flag_ranks, 2, tmp_path):
        assert out["ep"] == {"data": 1, "expert": 2}
        assert out["ep1"] == {"data": 2, "expert": 1}
        assert out["both"] == {"data": 1, "expert": 2}
        assert out["mp"] == {"data": 1, "model": 2}
        assert out["none"] is None
        assert "not divisible by model_parallel=3" in out["indivisible"]


def test_torch_moe_on_a_data_axis_raises():
    """An MoE tower is put on a mesh as JAX puts it: at (data 2, model 1)
    nothing splits (its routing is made global in the step, see
    ``tests/test_torch_ep.py``); at (data 1, expert 2) each tower MoE leaf
    keeps this rank's expert, and the layer runs its expert."""
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.models import build_whisper_flamingo
    from avsl_tpu_torch.models.moe import MoEFFN
    from avsl_tpu_torch.train import TrainState

    def build():
        return build_whisper_flamingo(
            "test", add_gated_x_attn=1, dtype="float32", device="cpu",
            av_hubert_cfg=AVHuBERTConfig.tiny_test(dtype="float32", n_experts=2))[0]

    state = part.shard_state(TrainState.create(build(), None), fake_mesh(2, 1))
    assert state.layout.tp == {}
    assert all(m.parallel is None for m in state.model.modules() if isinstance(m, MoEFFN))
    whole = build().state_dict()
    ep = SimpleNamespace(shape={"data": 1, "expert": 2}, data_rank=0, expert_rank=1,
                         expert_group=None, device=torch.device("cpu"))
    state = part.shard_state(TrainState.create(build(), None), ep)
    moes = [m for m in state.model.modules() if isinstance(m, MoEFFN)]
    assert moes and all(m.parallel == ("expert", None, 1, 2) for m in moes)
    names = [n for n in whole if n.split(".")[-1] in ("w_in", "b_in", "w_out", "b_out")]
    assert sorted(state.layout.tp) == sorted(names) and set(state.layout.tp.values()) == {0}
    local = dict(state.model.named_parameters())
    for n in names:
        torch.testing.assert_close(local[n], whole[n][1:2], atol=0, rtol=0)


def test_torch_num_devices_against_the_world_raises(monkeypatch):
    import avsl_tpu_torch.core.mesh as mesh_mod
    from avsl_tpu_torch.cli.finetune import make_mesh_for

    assert make_mesh_for(SimpleNamespace(num_devices=1, model_parallel=2)) is None
    with pytest.raises(RuntimeError, match="torch.distributed.run --nproc_per_node 4"):
        make_mesh_for(SimpleNamespace(num_devices=4, model_parallel=1))
    monkeypatch.setattr(mesh_mod, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="num_devices=4 but torch.distributed.run started 2"):
        make_mesh_for(SimpleNamespace(num_devices=4, model_parallel=1))
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(2)


def _launch(tmp_path, name, **keys):
    from test_torch_flamingo_cli import _yaml

    run_dir = tmp_path / name
    run_dir.mkdir()
    cfg = _yaml(run_dir, num_devices=2, train_id="mesh", **keys)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "avsl_tpu_torch.cli.finetune", cfg, "--smoke", "--device", "cpu"],
        cwd=run_dir, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return run_dir, proc.stdout


@pytest.mark.parametrize("keys", [dict(zero1="true"), dict(model_parallel=2, fsdp="true")],
                         ids=["dp2_zero1", "mp2_fsdp"])
def test_torch_finetune_cli_on_two_ranks(tmp_path, keys):
    run_dir, stdout = _launch(tmp_path, "run", **keys)
    assert stdout.count("done: step=6") == 1
    assert sorted(os.listdir(run_dir / "ckpt" / "mesh")) == ["best", "step_3.pt", "step_6.pt"]
    lines = [json.loads(line) for line in open(run_dir / "logs" / "mesh" / "metrics.jsonl")]
    assert [line["step"] for line in lines if "train/loss" in line] == [6]
    assert all(np.isfinite(line["train/loss"]) for line in lines if "train/loss" in line)
    # the sanity validation at step 0, then every 3 steps: each line once
    assert [line["step"] for line in lines if "val/wer_av" in line] == [0, 3, 6]
