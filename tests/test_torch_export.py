"""The serving programs as ``torch.export`` artifacts
(``avsl_tpu_torch/infer/export.py``, ``cli/export_program.py``) on the CPU.

Exported, saved, loaded and replayed without model code, a program gives
the live transcriber's tokens, with avg_logprob (or the beam's score)
within 1e-6: greedy on the tiny Whisper-Flamingo model (lip features in
the batch), a beam of 2, and int8 weights with the int8 cache (each
program holding the int8 weights it reads). The encode program holds the
flash-attention forward as the custom op ``avsl_tpu_torch::flash_attn_fwd``,
one node an encoder block. The manifest has exactly the JAX manifest's keys (read
from ``avsl_tpu/infer/export.py``) with ``format`` "torch.export"; other
platforms raise, and so does ``cuda`` without a card. Speculative
decoding and the CLI are in ``test_torch_export_programs.py``.
"""

import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from avsl_tpu_torch.cli import export_program
from avsl_tpu_torch.data.tokenizer import ByteTokenizer
from avsl_tpu_torch.infer import StreamingTranscriber, export_serving_program, load_exported
from avsl_tpu_torch.models import build_whisper_flamingo
from avsl_tpu_torch.models.quant import quantized_weights
from test_torch_flamingo_common import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
KW = dict(audio_max_length=16000, video_frames=8, batch_size=2, max_new_tokens=6)
K1 = "avsl_tpu_torch.flash_attn_fwd.default"


def jax_manifest_keys():
    """The keys of the manifest dict in ``avsl_tpu/infer/export.py``."""
    tree = ast.parse((REPO / "avsl_tpu/infer/export.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "manifest"):
            return {k.value for k in node.value.keys}
    raise AssertionError("no manifest dict in the JAX export module")


@pytest.fixture(scope="module")
def av_model():
    vocab = ByteTokenizer().add_tokens(["<laugh>"])
    model, _ = build_whisper_flamingo("test", vocab_size=vocab, dtype="float32", device="cpu",
                                      seed=3)
    with torch.no_grad():  # nonzero gates, as a trained model has them
        for block in model.decoder.blocks:
            block.x_attn_gate.fill_(0.7)
            block.x_mlp_gate.fill_(-0.4)
    draft, _ = build_whisper_flamingo("test", vocab_size=vocab, add_gated_x_attn=0,
                                      dtype="float32", device="cpu", seed=4)
    return model, draft


def _batch(tr):
    rng = np.random.default_rng(0)
    items = [{"id": str(i), "audio": (0.1 * rng.standard_normal(12000)).astype(np.float32)}
             for i in range(2)]
    items[0]["lip_feats"] = rng.normal(size=(8, 88, 88, 1)).astype(np.float32)
    b = tr._prepare_batch(items)
    return torch.from_numpy(b.audio), torch.from_numpy(b.video)


def _round_trip(tr, tmp_path):
    path = str(tmp_path / "prog")
    manifest = export_serving_program(tr, path, ["cpu"])
    call, loaded = load_exported(path, "cpu")
    assert loaded == manifest
    audio, video = _batch(tr)
    with torch.inference_mode():
        live = tr._run(audio.numpy(), video)
    out = call(audio, video, tr._prompt)
    np.testing.assert_array_equal(out[0].numpy(), live.tokens)
    np.testing.assert_allclose(out[1].numpy(), live.scores, atol=1e-6)
    return manifest, out, path


@pytest.mark.parametrize("opts", [{}, {"beam_size": 2}, {"quantize": "int8", "kv_int8": True}])
def test_torch_export_replay_matches_live(av_model, tmp_path, opts):
    tr = StreamingTranscriber(av_model[0], ByteTokenizer(), **KW, **opts)
    manifest, _, path = _round_trip(tr, tmp_path)
    assert set(manifest) == jax_manifest_keys()
    assert manifest["format"] == "torch.export" and manifest["platforms"] == ["cpu"]
    assert manifest["beam_size"] == opts.get("beam_size", 1)
    assert (manifest["quantize"], manifest["kv_int8"]) == (opts.get("quantize"),
                                                          opts.get("kv_int8", False))
    assert manifest["speculative"] is False and manifest["spec_k"] is None
    assert manifest["inputs"][1]["shape"] == [2, 8, 88, 88, 1]
    assert manifest["bytes"] == sum(f.stat().st_size for f in Path(path).rglob("*.pt2"))
    prog = torch.export.load(os.path.join(path, "cpu", "encode.pt2"))
    k1 = [n for n in prog.graph.nodes if str(n.target) == K1]
    cfg = tr.model.cfg
    assert len(k1) == cfg.n_audio_layer + tr.model.video_model.cfg.num_hidden_layers
    step = torch.export.load(os.path.join(path, "cpu", "step.pt2"))
    int8 = {f"{name}:{k}" for name, p in (("encode", prog), ("step", step))
            for k, v in p.state_dict.items() if v.dtype == torch.int8}
    assert bool(int8) == bool(opts.get("quantize"))
    if opts.get("quantize"):  # each program holds the int8 weights it reads
        assert len(int8) >= len(quantized_weights(tr.model))
        assert any("token_embedding" in k for k in int8 if k.startswith("step:"))
        assert any("conv1" in k for k in int8 if k.startswith("encode:"))


def test_torch_export_refuses_other_platforms(av_model, tmp_path):
    tr = StreamingTranscriber(av_model[0], ByteTokenizer(), **KW)
    with pytest.raises(ValueError, match="exports for"):
        export_serving_program(tr, str(tmp_path / "p"), ["tpu"])
    with pytest.raises(ValueError, match="exports for"):
        export_program.main(["--smoke", "--platforms", "cpu,rocm", "--output",
                             str(tmp_path / "q")])
    assert not (tmp_path / "q").exists()  # refused before anything is built
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_serving_program(tr, str(tmp_path / "r"), ["cuda"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_program.main(["--smoke", "--output", str(tmp_path / "s")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_exported(str(tmp_path / "p"))
