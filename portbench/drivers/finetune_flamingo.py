"""Whisper-Flamingo fine-tuning through the port's ``cli/finetune.py``:
``make_job`` on in-memory rows (the configuration's ``train`` keys as the
YAML gives them), ``train_batches`` (the bucketed loader, ``MultiSteps``
accumulation across batches) and the job runner's ``train_step``, the
call ``TrainerRunner.fit`` makes; validation is off in the window.

Traffic keys: ``pool`` rows of ``audio_seconds`` PCM with ``frames`` lip
frames each and a transcript (``words``: its law of lengths), and
``checked_updates``. The dataset of the port reads lip clips from files
through OpenCV; here each row's clip is held in memory and handed over
in the loader's normalisation, the one stand-in for the file.

Set-up drives the one job from the seed through ``checked_updates``
optimizer steps through that call and that feed, on rows that all
differ, and keeps what the check compares: each micro-step's loss, the
norm of each trained tensor's first clipped gradient (Adam's first moment
after one update over ``1 - b1``) and of its change after the last. The
window continues the same job: ``train_segments_per_s`` is the segments
of the optimizer steps completed in it over their time. The check frees
the program and runs the plain reference through the same steps on the
same rows, from the same seed-made weights and the same generator seed.

Controls: ``fp8`` (the reference at fp8 in the program's place),
``half_batch`` (each micro-batch's first half fed to the program, which
then takes the mean over those rows), ``unchanged_state`` (the program's
optimizer updates nothing).
"""

from __future__ import annotations

import gc
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import data, flops, steps, weights
from portbench.reference import precision, spec
from portbench.reference import train as ref_train

ROOT = Path(__file__).resolve().parent.parent.parent


class ClipRows:
    """The port's dataset with each row's lip clip taken from memory, in the
    normalisation its clip loader applies; records the rows it is asked for,
    in order."""

    def __init__(self, ds, frames_u8: np.ndarray, log: List[int]):
        self.ds, self.frames, self.log = ds, frames_u8, log

    def __len__(self) -> int:
        return len(self.ds)

    def audio_length(self, idx: int) -> int:
        return self.ds.audio_length(idx)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        out = self.ds[idx]
        out["video"] = data.normalise(self.frames[idx])[..., None]
        self.log.append(int(idx))
        return out


@dataclass
class State:
    ctx: Any
    job: Any = None
    audio: np.ndarray = None
    frames: np.ndarray = None
    texts: List[str] = field(default_factory=list)
    fed: List[int] = field(default_factory=list)
    it: Any = None
    epoch: int = 0
    micro_rows: List[int] = field(default_factory=list)
    got: Dict[str, Any] = field(default_factory=dict)


def train_config(cfg: dict):
    from avsl_tpu_torch.core.config import FlamingoTrainConfig

    tcfg = FlamingoTrainConfig()
    for k, v in cfg["train"].items():
        setattr(tcfg, k, v)
    logs = ROOT / "build" / "portbench" / "finetune"
    tcfg.log_output_dir, tcfg.check_output_dir = str(logs / "logs"), str(logs / "ckpt")
    tcfg.train_id = "portbench"
    tcfg.num_sanity_val_steps = 0
    return tcfg


def _batch(st: State):
    from avsl_tpu_torch.cli.finetune import train_batches

    while True:
        if st.it is None:
            st.it = train_batches(st.job, st.epoch)
        try:
            return next(st.it)
        except StopIteration:
            st.it, st.epoch = None, st.epoch + 1


def micro_step(st: State):
    """One call of the runner's step on the next batch of the feed.
    Returns (loss tensor, rows in the batch, whether the optimizer updated)."""
    runner = st.job.runner
    batch = _batch(st)
    rows = int(np.asarray(batch["labels"]).shape[0])
    if st.ctx.control == "half_batch":
        batch = {k: v[: rows // 2] for k, v in batch.items()}
    runner.state, metrics = runner.train_step(runner.state, runner.reshape_accum(batch))
    st.micro_rows.append(rows)
    return metrics["loss"], rows, runner.state.optimizer.mini_step == 0


def setup(ctx) -> State:
    from avsl_tpu_torch.cli.finetune import make_job

    cfg, tr = ctx.cfg, ctx.traffic
    st = State(ctx)
    n = tr["pool"]
    tc = cfg["train"]
    st.audio = data.audio(n, tr["audio_seconds"], ctx.seed, ctx.device)
    st.frames = data.lip_frames(n, tr["frames"], 88, ctx.seed, ctx.device)
    st.texts = data.transcripts(n, tr["words"], ctx.seed)
    rows = [{"audio": {"array": st.audio[i], "sampling_rate": data.SAMPLE_RATE},
             "transcript": st.texts[i], "duration": tr["audio_seconds"], "lip_video": None}
            for i in range(n)]
    if ctx.control == "fp8":
        return st  # the reference in the program's place: nothing of the program runs
    job = make_job(train_config(cfg), rows, None, None, ctx.device,
                   vocab_size=cfg["whisper"]["n_vocab"], seed=ctx.seed)
    if job.runner.accum != 1 or job.runner.hoisted:
        raise RuntimeError("the job does not accumulate across batches through MultiSteps")
    job.model.load_state_dict(weights.make(spec.whisper_flamingo(cfg), ctx.seed, ctx.device,
                                           gate=cfg["gate"]))
    job.train_ds = ClipRows(job.train_ds, st.frames, st.fed)
    st.job = job
    gc.collect()
    opt = job.runner.state.optimizer
    if ctx.control == "unchanged_state":
        def no_update(grads, grad_norm=None):
            opt.inner.count += 1
        opt.inner.step = no_update
    start = steps.host_copy(opt.params)
    losses = []
    for _ in range(tr["checked_updates"] * tc["gradient_accumulation_steps"]):
        loss, _, updated = micro_step(st)
        losses.append(loss)
        if updated and opt.count == 1:
            st.got["grad_norms"] = steps.grad_norms(opt.names, opt.inner)
    st.got["change_norms"] = steps.change_norms(opt.names, opt.params, start)
    st.got["losses"] = [float(x) for x in losses]
    del start
    if opt.count != tr["checked_updates"]:
        raise RuntimeError(f"{opt.count} updates in set-up, not {tr['checked_updates']}")
    return st


def window(st: State, seconds: float) -> Dict[str, Any]:
    cfg, tr, tc = st.ctx.cfg, st.ctx.traffic, st.ctx.cfg["train"]
    if st.job is None:  # the fp8 control runs no program
        return {"end_to_end": {"train_segments_per_s": 0.0}, "attempted": 0, "failed": 0,
                "kind": "train", "segments": 0, "seconds": seconds, "model_ops": 0.0}
    ran = []

    def one():
        loss, rows, updated = micro_step(st)
        ran.append((loss.detach(), rows))
        return rows, updated

    done = steps.timed(one, seconds, st.ctx.device == "cuda")
    label_len = min(tc["text_max_length"], cfg["whisper"]["n_text_ctx"])
    seg_ops = flops.flamingo_train_segment(cfg, tc["audio_max_length"] // 160, tr["frames"], 88,
                                           label_len)
    return {"end_to_end": {"train_segments_per_s": done["segments"] / done["seconds"]},
            "attempted": done["segments"], "failed": steps.failed_rows(ran), "kind": "train",
            "model_ops": done["segments"] * seg_ops, **done}


def _micro_batches(st: State, rows_per_micro: List[int], count: int) -> List[dict]:
    out, pos = [], 0
    for n in rows_per_micro[:count]:
        idx = st.fed[pos: pos + n]
        pos += n
        out.append(ref_train.micro_batch(
            st.ctx.cfg, [{"audio": st.audio[i], "text": st.texts[i], "frames": st.frames[i]}
                         for i in idx], st.ctx.device))
    return out


def check(st: State) -> List[Dict[str, Any]]:
    ctx, cfg, tr = st.ctx, st.ctx.cfg, st.ctx.traffic
    accum = cfg["train"]["gradient_accumulation_steps"]
    count = tr["checked_updates"] * accum
    if st.job is not None:
        st.job = None
        gc.collect()
        if ctx.device == "cuda":
            torch.cuda.empty_cache()
        got = st.got
        mbs = _micro_batches(st, st.micro_rows, count)
    else:
        st.fed = list(data.order(tr["pool"], count * cfg["train"]["batch_size"], ctx.seed, 8))
        mbs = _micro_batches(st, [cfg["train"]["batch_size"]] * count, count)
        precision.exact_fp32()
        got = ref_train.flamingo_run(precision.Precision("fp8"), _weights(ctx), cfg, mbs, ctx.seed,
                            tr["checked_updates"])
    precision.exact_fp32()
    want = ref_train.flamingo_run(precision.Precision("fp32"), _weights(ctx), cfg, mbs, ctx.seed,
                         tr["checked_updates"])
    gaps = ref_train.compare(got, want)
    return [{"name": k, "value": v, "limit": ctx.limits[k]["limit"], "at": at}
            for k, (v, at) in gaps.items()]


def _weights(ctx):
    return weights.make(spec.whisper_flamingo(ctx.cfg), ctx.seed, ctx.device, gate=ctx.cfg["gate"])
