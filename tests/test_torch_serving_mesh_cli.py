"""The serving CLIs on a mesh, one process a rank under ``python -m
torch.distributed.run --standalone --nproc_per_node 2`` on the CPU (gloo):

* ``cli.transcribe --smoke --model_parallel 2`` over three wavs: rc 0,
  only rank 0 prints (three result lines) and writes ``--output``, with
  the texts and log-probabilities of the same CLI in one process (within
  1e-4, the CLI's rounding);
* ``cli.serve --smoke --data_parallel 2``: rank 0 binds and prints its
  address once, rank 1 follows its batches and stops with it; rc 0.
"""

import json
import os
import subprocess
import sys

import numpy as np
import scipy.io.wavfile as wavfile

from avsl_tpu_torch.cli import transcribe
from test_torch_flamingo_common import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launch(cwd, module, *flags):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", module, "--smoke", "--device", "cpu", *flags],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return [line for line in proc.stdout.splitlines() if line.startswith("{")]


def test_torch_transcribe_cli_on_two_model_ranks(tmp_path):
    wavs = tmp_path / "in"
    wavs.mkdir()
    for i in range(3):
        pcm = 0.1 * np.random.default_rng(i).standard_normal(16000)
        wavfile.write(str(wavs / f"u{i}.wav"), 16000, pcm.astype(np.float32))
    out = tmp_path / "out.json"
    lines = _launch(tmp_path, "avsl_tpu_torch.cli.transcribe", "--model_parallel", "2",
                    "--input", str(wavs), "--output", str(out), "--batch_size", "2",
                    "--max_new_tokens", "4")
    assert len(lines) == 3
    got = json.loads(out.read_text())
    want = transcribe.main(["--smoke", "--device", "cpu", "--input", str(wavs),
                            "--batch_size", "2", "--max_new_tokens", "4"])
    assert [r["id"] for r in got] == [r["id"] for r in want] == ["u0", "u1", "u2"]
    assert [r["text"] for r in got] == [r["text"] for r in want]
    np.testing.assert_allclose([r["avg_logprob"] for r in got],
                               [r["avg_logprob"] for r in want], rtol=0, atol=1e-4)


def test_torch_serve_cli_on_two_data_ranks(tmp_path):
    lines = _launch(tmp_path, "avsl_tpu_torch.cli.serve", "--data_parallel", "2",
                    "--batch_size", "2", "--port", "0")
    assert len(lines) == 1 and json.loads(lines[0])["ok"] is True
