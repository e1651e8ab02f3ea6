"""The whole chain on the synthetic mini-AMI corpus through
``avsl_tpu_torch`` alone (CPU): the port's counterpart of
``tests/test_integration_mini_corpus.py``, on the same fixture (NITE XML,
a 4 s headset wav and a 4 s closeup with a moving synthetic face).

annotations -> transcripts txt -> segment collection -> audio/video
segmentation -> lip-ROI extraction (the warp on the CPU) -> HF dataset
packaging -> ``cli.finetune`` for 2 steps -> ``cli.transcribe --smoke``,
then ``cli.evaluate`` of the fine-tuned checkpoint on the packaged
dataset, each with the JAX test's assertions. The chain runs in a
subprocess, whose ``sys.modules`` never holds ``avsl_tpu`` or ``jax``.
"""

import json
import os
import subprocess
import sys

from test_integration_mini_corpus import mini_corpus  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHAIN = r'''
import json, os, sys
import numpy as np
import torch
import yaml

torch.set_num_threads(1)
corpus, work = sys.argv[1], sys.argv[2]
from avsl_tpu_torch.data.ami_xml import process_transcripts
from avsl_tpu_torch.data.dataset_process import segment_sources
from avsl_tpu_torch.data.video_io import read_video_frames

out = os.path.join(work, "out")
written = process_transcripts(os.path.join(corpus, "transcripts"), os.path.join(out, "txt"))
assert len(written) == 1
lines = open(written[0]).read().strip().splitlines()
assert lines[0] == "[0.50-1.40] hello there", lines

result = segment_sources(
    os.path.join(out, "txt"),
    audio_sources={("X", "A"): os.path.join(corpus, "media", "X.Headset-0.wav")},
    video_sources={("X", "A"): os.path.join(corpus, "media", "X.Closeup1.avi")},
    output_dir=os.path.join(out, "ds"), extract_lips=True, device="cpu")
stats = result["stats"]
assert stats == {"segments": 2, "audio_ok": 2, "video_ok": 2, "lip_ok": 2,
                 "alignment_issues": 0}, stats
assert len(result["dataset"]) == 2
lip_dir = os.path.join(out, "ds", "lip_videos")
lip_files = sorted(os.listdir(lip_dir))
assert len(lip_files) == 2
assert read_video_frames(os.path.join(lip_dir, lip_files[0])).shape[1:] == (96, 96)

from avsl_tpu_torch.cli import evaluate, finetune, transcribe

hf_dir = os.path.join(out, "ds", "hf_dataset")
cfg = {"model_name": "test", "train_data_path": hf_dir, "val_data_path": hf_dir,
       "test_data_path": "", "audio_max_length": 16000, "batch_size": 2,
       "eval_batch_size": 2, "num_train_steps": 2, "warmup_steps": 1,
       "gradient_accumulation_steps": 1, "validate_every_n_batches": 100,
       "add_gated_x_attn": 1, "use_av_hubert_encoder": True, "spec_augment": None,
       "precision": 32, "train_id": "mini_corpus",
       "log_output_dir": os.path.join(work, "logs"),
       "check_output_dir": os.path.join(work, "ckpt"), "num_sanity_val_steps": 0,
       "max_duration_filter_seconds": 10.0, "prefetch_batches": 1}
cfg_path = os.path.join(work, "cfg.yaml")
with open(cfg_path, "w") as f:
    yaml.safe_dump(cfg, f)
os.chdir(work)
fit = finetune.main([cfg_path, "--device", "cpu"])
assert fit["final_step"] == 2, fit["final_step"]
assert np.isfinite(fit["history"][-1][1]) if fit["history"] else True

segs_dir = os.path.join(out, "ds", "audio_segments")
assert len(transcribe.collect_items(segs_dir)) == 2
res = transcribe.main(["--input", segs_dir, "--smoke", "--batch_size", "2",
                       "--max_new_tokens", "4", "--device", "cpu"])
assert len(res) == 2

eval_path = os.path.join(work, "eval.yaml")
with open(eval_path, "w") as f:
    yaml.safe_dump(dict(cfg, test_data_path=hf_dir), f)
metrics = evaluate.main(["--config", eval_path, "--device", "cpu", "--beam", "2",
                         "--max_new_tokens", "4",
                         "--ckpt_dir", os.path.join(work, "ckpt", "mini_corpus")])
assert all(np.isfinite(metrics[k]) for k in ("test/loss", "test/wer_av", "test/wer_beam"))
print("MODULES " + json.dumps(sorted(m for m in sys.modules
                                      if m.split(".")[0] in ("jax", "avsl_tpu", "flax"))))
'''


def test_torch_full_pipeline(mini_corpus, tmp_path):  # noqa: F811
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", CHAIN, str(mini_corpus), str(tmp_path)],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "restored checkpoint step 2" in out.stdout
    line = [x for x in out.stdout.splitlines() if x.startswith("MODULES ")][-1]
    assert json.loads(line[len("MODULES "):]) == []
