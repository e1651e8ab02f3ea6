"""Exported serving programs with a draft, and the export CLI, on the
CPU: replaying the four programs of a speculative transcriber (its encode
and step, the draft's encode and step) gives the live transcriber's
tokens, scores, acceptance and rounds, the temperature fallback listed as
host-side; ``cli.export_program --smoke --platforms cpu`` writes an
artifact that replays, and without ``--smoke`` wants ``--ckpt_dir``.
"""

import os

import pytest
import torch

from avsl_tpu_torch.cli import export_program
from avsl_tpu_torch.data.tokenizer import ByteTokenizer
from avsl_tpu_torch.infer import StreamingTranscriber, load_exported
from test_torch_export import KW, _batch, _round_trip, av_model  # noqa: F401
from test_torch_flamingo_common import one_torch_thread  # noqa: F401


def test_torch_export_speculative_replay(av_model, tmp_path):
    model, draft = av_model
    tr = StreamingTranscriber(model, ByteTokenizer(), draft_model=draft, spec_k=3,
                              temperature_fallback=(0.2,), **KW)
    audio, video = _batch(tr)
    with torch.inference_mode():
        x = audio.to(tr.device)
        want = tr._decode(*tr.encode(x, video), dfeats=tr.encode_draft(x))
    manifest, out, path = _round_trip(tr, tmp_path)
    assert manifest["speculative"] is True and manifest["spec_k"] == 3
    assert manifest["host_side_not_exported"] == ["temperature_fallback"]
    assert sorted(os.listdir(os.path.join(path, "cpu"))) == [
        "draft_encode.pt2", "draft_step.pt2", "encode.pt2", "step.pt2"]
    assert float(out[2]) == float(want.accept_rate) and out[3] == want.rounds


def test_torch_export_program_cli_smoke(tmp_path):
    out = str(tmp_path / "art" / "model")
    manifest = export_program.main(["--smoke", "--platforms", "cpu", "--output", out,
                                    "--batch_size", "2", "--max_new_tokens", "3"])
    assert os.path.exists(out + ".json") and os.path.isdir(os.path.join(out, "cpu"))
    assert manifest["inputs"][0]["shape"] == [2, 16000]
    call, _ = load_exported(out, "cpu")
    tokens, scores = call(torch.zeros(2, 16000), torch.zeros(2, 25, 88, 88, 1),
                          torch.tensor([[257, 258, 259, 260]] * 2))
    assert tokens.shape == (2, 3) and torch.isfinite(scores).all()
    with pytest.raises(SystemExit, match="--ckpt_dir required"):
        export_program.main(["--platforms", "cpu", "--output", out])
