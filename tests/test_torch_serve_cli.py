"""``python -m avsl_tpu_torch.cli.serve``: ``--smoke --device cpu`` binds,
prints its address and stops; the mesh flags outside
``torch.distributed.run`` raise before a model is built; without ``--device
cpu`` it needs CUDA; and the serving options reach the transcriber, int8
weights, the int8 cache and a speculative draft included."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from avsl_tpu_torch.cli import serve
from test_torch_flamingo_common import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def test_torch_serve_cli_smoke_on_cpu(capsys):
    srv = serve.main(["--smoke", "--device", "cpu", "--batch_size", "2",
                      "--max_new_tokens", "2", "--port", "0"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] is True and out["address"].startswith("http://127.0.0.1:")
    tr = srv.transcriber
    assert tr.device == torch.device("cpu") and tr.batch_size == 2
    assert tr.model.cfg.add_gated_x_attn  # the JAX CLI's default: Whisper-Flamingo


def test_torch_serve_cli_module_entry():
    proc = subprocess.run([sys.executable, "-m", "avsl_tpu_torch.cli.serve", "--smoke",
                           "--device", "cpu", "--port", "0", "--batch_size", "2"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["ok"] is True


def test_torch_serve_cli_passes_serving_options():
    srv = serve.main(["--smoke", "--device", "cpu", "--port", "0", "--batch_size", "2",
                      "--temperature_fallback", "0.2,0.4", "--logprob_threshold", "-2.5",
                      "--word_timestamps"])
    tr = srv.transcriber
    assert tr.temperature_fallback == (0.2, 0.4) and tr.logprob_threshold == -2.5
    assert tr.word_timestamps and tr._biasing is None  # as JAX's CLI, no boost flag


@pytest.mark.parametrize("flags,item", [
    (["--model_parallel", "2"], "torch.distributed.run"),
    (["--data_parallel", "2"], "torch.distributed.run"),
])
def test_torch_serve_cli_refuses_later_work(flags, item, monkeypatch):
    """A mesh needs the launcher's process group: one process a rank."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match=item):
        serve.main(["--smoke", "--device", "cpu", "--port", "0", *flags])


def test_torch_serve_cli_needs_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--port", "0"])


def test_torch_serve_cli_takes_int8_and_a_draft():
    srv = serve.main(["--smoke", "--device", "cpu", "--port", "0", "--batch_size", "2",
                      "--quantize", "int8", "--kv_int8", "--draft_model", "test",
                      "--spec_k", "3"])
    tr = srv.transcriber
    assert (tr.quantize, tr.kv_int8, tr.spec_k) == ("int8", True, 3)
    assert tr.draft_model is not None and not tr.draft_model.cfg.add_gated_x_attn
    assert tr.model.decoder.blocks[0].attn.query.parametrizations.weight.original0.dtype == (
        torch.int8)
    with pytest.raises(SystemExit, match="needs --draft_ckpt"):
        serve.main(["--device", "cpu", "--port", "0", "--draft_model", "tiny"])

