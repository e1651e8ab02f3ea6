"""Checkpoints on a mesh and ``restore_sharded`` through ``avsl_tpu_torch``
(CPU, gloo ranks).

The tiny Whisper-Flamingo trains 2 accumulated steps at dp 2 under FSDP
and saves: every rank gathers the logical state and rank 0 writes the
one file. ``restore_sharded`` then puts that file into a fresh state at
dp 1 (a mesh of one rank), at dp 1 x mp 2 (tensor-parallel slices,
``test_train.py:239`` in JAX: the rule-sharded leaves and their Adam
moments really split over the model axis), at dp 2 under ZeRO-1 and
FSDP, and with no mesh; each restored state is saved again and must
hold the same tensors, bit for bit, as the file it came from. A
checkpoint written without a mesh restores onto dp 1 x mp 2 the same
way (the writer's layout does not matter).
"""

import numpy as np
import pytest
import torch

from avsl_tpu_torch.train.checkpoints import restore_sharded, save_checkpoint
from test_torch_flamingo_common import carried_flamingo, one_torch_thread  # noqa: F401
from test_torch_flamingo_loss import make_batch
from torch_mesh_workers import _flamingo_state, restore_ranks, spawn

QUERY, OUT, EMB = ("decoder.blocks.0.x_attn.query.weight", "decoder.blocks.0.x_attn.out.weight",
                   "decoder.token_embedding.weight")


def assert_same_file(a, b):
    x = torch.load(a, weights_only=True)
    y = torch.load(b, weights_only=True)
    assert x["step"] == y["step"] == 2
    assert sorted(x["model"]) == sorted(y["model"])
    for k in x["model"]:
        assert torch.equal(x["model"][k], y["model"][k]), k
    ox, oy = x["optimizer"], y["optimizer"]
    assert ox["names"] == oy["names"] and ox["count"] == oy["count"] == 2
    for key in ("mu", "nu"):
        for n, s, t in zip(ox["names"], ox[key], oy[key]):
            assert torch.equal(s, t), (key, n)
    assert any(float(m.abs().max()) > 0 for m in ox["mu"])
    assert torch.equal(x["generator"], y["generator"])


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("restore")
    _, _, port, cfg = carried_flamingo()
    path = str(tmp / "state.pt")
    torch.save(port.state_dict(), path)
    batch = make_batch(cfg, np.random.default_rng(4), lead=(2, 4))
    ckpt = str(tmp / "fsdp_dp2")
    spawn(restore_ranks, 2, tmp, path, ckpt, None, batch, None)
    plain = str(tmp / "plain")
    state, _ = _flamingo_state(path)
    state.step = 2
    state.optimizer.count = 2
    with torch.no_grad():
        for m in state.optimizer.mu + state.optimizer.nu:
            m.normal_()
    save_checkpoint(plain, state, 1)
    shapes2 = spawn(restore_ranks, 2, tmp, path, ckpt, str(tmp / "out"), None,
                    [("mp2", 2, False, False), ("zero1", 1, True, False),
                     ("fsdp", 1, False, True)])
    shapes1 = spawn(restore_ranks, 1, tmp, path, ckpt, str(tmp / "out"), None,
                    [("dp1", 1, False, False)])
    shapes_plain = spawn(restore_ranks, 2, tmp, path, plain, str(tmp / "out_plain"), None,
                         [("mp2", 2, False, False)])
    return {"tmp": tmp, "path": path, "ckpt": ckpt, "plain": plain, "shapes2": shapes2,
            "shapes1": shapes1, "shapes_plain": shapes_plain}


@pytest.mark.parametrize("layout", ["mp2", "zero1", "fsdp", "dp1"])
def test_torch_restore_sharded_into_layout(saved, layout):
    """The FSDP dp 2 checkpoint, restored into ``layout`` and saved again:
    the same tensors."""
    assert_same_file(saved["ckpt"] + "/step_1.pt", f"{saved['tmp']}/out/{layout}/step_1.pt")


def test_torch_restore_sharded_reshards_onto_new_topology(saved):
    """Under mp 2 the column-parallel query keeps half its rows, the
    row-parallel output half its columns, the 256-id embedding half its
    rows, and the Adam moments follow; a checkpoint written without a mesh
    restores there to the same tensors."""
    full = torch.load(saved["ckpt"] + "/step_1.pt", weights_only=True)["model"]
    for shapes in saved["shapes2"]:
        mp2 = shapes["mp2"]
        q, o, e = full[QUERY].shape, full[OUT].shape, full[EMB].shape
        assert mp2[QUERY] == (q[0] // 2, q[1]) and mp2[OUT] == (o[0], o[1] // 2)
        assert mp2[EMB] == (e[0] // 2, e[1])
        assert shapes["fsdp"][QUERY][0] == q[0] // 2
    assert saved["shapes1"][0]["dp1"][QUERY] == tuple(full[QUERY].shape)
    for rank in (0, 1):
        assert saved["shapes_plain"][rank]["mp2"] == saved["shapes2"][rank]["mp2"]
    x = torch.load(saved["plain"] + "/step_1.pt", weights_only=True)
    y = torch.load(f"{saved['tmp']}/out_plain/mp2/step_1.pt", weights_only=True)
    for k in x["model"]:
        assert torch.equal(x["model"][k], y["model"][k]), k
    for s, t in zip(x["optimizer"]["mu"], y["optimizer"]["mu"]):
        assert torch.equal(s, t)


def test_torch_restore_sharded_without_mesh(saved, tmp_path):
    """``restore_sharded(..., mesh=None)`` is the plain restore: the whole
    state in a process without a process group."""
    state, _ = _flamingo_state(saved["path"])
    restore_sharded(saved["ckpt"], state, None)
    assert state.step == 2 and state.layout is None
    save_checkpoint(str(tmp_path / "again"), state, 1)
    assert_same_file(saved["ckpt"] + "/step_1.pt", str(tmp_path / "again" / "step_1.pt"))
