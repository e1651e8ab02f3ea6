"""The serving mesh through ``avsl_tpu_torch``: ``StreamingTranscriber(mesh=)``
on 2 gloo ranks against one process and against the JAX transcriber, on
the CPU.

The tiny Whisper-Flamingo (``carried_models``: the tiny video tower, gates
nonzero, fp32) and an audio-only tiny draft are carried from JAX. Each
variant runs in the same 2 ranks (``torch_mesh_workers.serve_ranks``, no
``jax`` in a rank) on a mesh of dp 1 x mp 2 or dp 2 x mp 1, and in one
spawned process without a mesh. JAX's cases:

* ``tests/test_infer.py:167``: the TP mesh (and here the data axis too)
  decodes the tokens and text of one device, the port's and JAX's on its
  8-device mesh at dp 2 x mp 4; every rank returns every item, in order.
* ``:207``: the refusals are in ``test_torch_mesh.py`` and
  ``test_torch_pipeline.py``.
* ``:325``: the serving options on a mesh: beam 2 at mp 2; word timestamps
  with the temperature fallback at threshold 0 (every row retries) at dp
  2, its noise drawn at the whole batch's shape, so the rows equal one
  process's.
* the int8 cross-attention cache (``kv_int8``, which JAX allows on a
  mesh) at mp 2, its rows over this rank's local heads: one process's
  tokens.
* ``tests/test_speculative.py:312``: the draft, whole on every rank, under
  the TP mesh: the tokens of plain greedy.
* ``tests/test_export_program.py:93``: a mesh transcriber is not exported.

Also the daemon on the mesh: rank 0's ``TranscriptionServer`` takes the
items through ``submit`` and rank 1 runs each of its batches
(``follow``), with the one-process tokens.

Tolerances: tokens, text and word boundaries equal; ``avg_logprob``
within 1e-4 (the transcriber's rounding to 4 places, where a row-parallel
sum's last bit can tip it).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from avsl_tpu.core.mesh import make_mesh as jax_make_mesh
from avsl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from avsl_tpu.infer import StreamingTranscriber as JaxTranscriber
from avsl_tpu_torch.data.tokenizer import ByteTokenizer
from avsl_tpu_torch.infer import StreamingTranscriber, export_serving_program
from test_torch_flamingo_common import one_torch_thread  # noqa: F401
from torch_mesh_workers import serve_ranks, spawn
from torch_serving_fixtures import carried_models, items, lip_feats

KW = dict(audio_max_length=16000, video_frames=25, batch_size=4, max_new_tokens=6)
VARIANTS = [
    ("mp2", 2, {}),
    ("dp2", 1, {}),
    ("beam", 2, {"beam_size": 2}),
    ("options", 1, {"word_timestamps": True, "temperature_fallback": (0.8,),
                    "logprob_threshold": 0.0}),
    ("draft", 2, {"draft": True}),
    ("kv_int8", 2, {"kv_int8": True}),
]
LOGPROB_ATOL = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serving_mesh")
    jmodel, variables, port = carried_models(av=True)
    _, _, draft = carried_models(av=False, seed=5)
    path, draft_path = str(tmp / "target.pt"), str(tmp / "draft.pt")
    torch.save(port.state_dict(), path)
    torch.save(draft.state_dict(), draft_path)
    its = items(6, seed=4)
    its[1]["lip_feats"] = lip_feats(20, seed=1)
    its[4]["lip_feats"] = lip_feats(25, seed=2)
    mesh = spawn(serve_ranks, 2, tmp, path, draft_path, its, KW, VARIANTS, 1)
    one = spawn(serve_ranks, 1, tmp, path, draft_path, its, KW, VARIANTS, 1)[0]
    jax_mesh = JaxTranscriber(jmodel, variables, JaxByteTokenizer(), **KW,
                              mesh=jax_make_mesh(8, model_parallel=4)).transcribe(its)
    return mesh, one, jax_mesh, its


def _assert_same(got, want):
    assert [g[0] for g in got] == [w[0] for w in want]
    assert [g[1] for g in got] == [w[1] for w in want]
    assert [g[2] for g in got] == [w[2] for w in want]
    assert [g[4] for g in got] == [w[4] for w in want]
    np.testing.assert_allclose([g[3] for g in got], [w[3] for w in want], rtol=0,
                               atol=LOGPROB_ATOL)


@pytest.mark.parametrize("name", ["mp2", "dp2"])
def test_torch_transcriber_tp_mesh_matches_single_device(runs, name):
    mesh, one, jax_mesh, its = runs
    for r in mesh:
        _assert_same(r[name], one[name])
    assert [g[2] for g in mesh[0][name]] == [list(r.tokens) for r in jax_mesh]
    assert [g[1] for g in mesh[0][name]] == [r.text for r in jax_mesh]
    assert [g[4] for g in mesh[0][name]] == [bool(it.get("lip_feats") is not None) for it in its]


def test_torch_serving_options_compose_on_a_mesh(runs):
    mesh, one, _, _ = runs
    for name in ("beam", "options"):
        for r in mesh:
            _assert_same(r[name], one[name])
    for r in mesh:
        assert [g[5] for g in r["options"]] == [w[5] for w in one["options"]]
        assert all(g[5] for g in r["options"])
        assert r["fallback_calls"] >= 1


def test_torch_transcriber_draft_under_tp_mesh_matches_single_device(runs):
    mesh, one, _, _ = runs
    for r in mesh:
        _assert_same(r["draft"], one["draft"])
        assert [g[2] for g in r["draft"]] == [w[2] for w in one["mp2"]]


def test_torch_transcriber_kv_int8_under_tp_mesh_matches_single_device(runs):
    mesh, one, _, _ = runs
    for r in mesh:
        _assert_same(r["kv_int8"], one["kv_int8"])


def test_torch_daemon_leads_the_mesh(runs):
    mesh, one, _, _ = runs
    assert mesh[0]["daemon"] == [w[:3] for w in one["mp2"]]
    assert mesh[1]["daemon_batches_followed"] >= 2


def test_torch_export_rejects_mesh_transcriber(tmp_path):
    tr = StreamingTranscriber(load_serving_carried(), ByteTokenizer(), **KW)
    tr.mesh = SimpleNamespace(shape={"data": 1, "model": 2})
    with pytest.raises(ValueError, match="mesh-sharded"):
        export_serving_program(tr, str(tmp_path / "never_written"))
    assert not (tmp_path / "never_written").exists()


def load_serving_carried():
    _, _, port = carried_models(av=True)
    return port
