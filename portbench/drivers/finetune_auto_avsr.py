"""Auto-AVSR audio-visual fine-tuning through the port's
``cli/auto_avsr_ft.py``: ``build_auto_avsr`` with the configuration's
model keys, the CLI's optimizer (``make_optimizer``), ``make_train_step``
over ``auto_avsr_loss_fn`` and batches collated by the CLI's
``collate_raw_av``, in seeded permutations of the rows; the benchmark's
weights are loaded into the model.

Traffic keys: ``pool`` rows of ``seconds`` of 16 kHz PCM and ``frames``
normalised lip frames (the configuration's ``image_crop_size``), labels
(``labels``: the range of their lengths) of ids in [4, odim - 1);
``checked_updates``. The batch is the configuration's
``train.batch_size``, one micro-batch an update.

Set-up imports the program first (a program without Auto-AVSR fails
there), then takes ``checked_updates`` steps through the window's call
and feed, on rows that all differ, and keeps each step's loss, each
tensor's first clipped gradient norm and its change after the last; the
window continues the same state, and with ``--trace 1`` records the
program's spans and counters around itself (``spans``, ``counters`` in
the window's dict; a recording already open around it, as
``spanrun.py``'s, is read instead); the check frees the program and runs
the plain reference (:mod:`portbench.reference.auto_avsr`) through the
same steps. Controls as for ``finetune_avhubert``: ``fp8``,
``half_batch``, ``unchanged_state``.
"""

from __future__ import annotations

import contextlib
import gc
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import data, flops_avsr, steps, weights
from portbench.reference import auto_avsr as ref_avsr
from portbench.reference import precision
from portbench.reference import train as ref_train


@dataclass
class State:
    ctx: Any
    step: Any = None
    state: Any = None
    rows: List[dict] = field(default_factory=list)
    order: Any = None
    used: int = 0
    fed: List[List[int]] = field(default_factory=list)
    got: Dict[str, Any] = field(default_factory=dict)
    ops: float = 0.0


def cosine(lr: float, warmup: int, total: int, count: int) -> float:
    """A linear warmup from 0 to ``lr`` over ``warmup`` updates, then a
    cosine to 0 at ``total``, in fp32."""
    f32 = np.float32
    if count < warmup:
        return float(f32(lr) * f32(count) / f32(warmup))
    c = f32(min(count - warmup, total - warmup)) / f32(total - warmup)
    return float(f32(lr) * f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * c)))


def optimizer(c: dict) -> dict:
    t = c["train"]
    return {"b2": 0.98, "eps": 1e-8, "weight_decay": 0.03, "clip_norm": 10.0, "accum": 1,
            "lr": lambda count: cosine(t["lr"], t["warmup_steps"], t["steps"], count)}


def _next_batch(st: State):
    from avsl_tpu_torch.cli.auto_avsr_ft import collate_raw_av

    bs = st.ctx.cfg["train"]["batch_size"]
    idx = [int(i) for i in st.order[st.used: st.used + bs]]
    st.used += bs
    st.fed.append(idx)
    return collate_raw_av([st.rows[i] for i in idx], st.ctx.cfg["model"]["odim"] - 1)


def one_step(st: State):
    batch = _next_batch(st)
    rows = len(batch["labels"])
    if st.ctx.control == "half_batch":
        batch = {k: v[: rows // 2] for k, v in batch.items()}
    st.state, metrics = st.step(st.state, batch)
    st.ops += flops_avsr.train_step(st.ctx.cfg["model"], len(batch["labels"]),
                                    batch["video"].shape[1], batch["audio"].shape[1],
                                    batch["labels"].shape[1])
    return metrics["loss"], rows


def setup(ctx) -> State:
    c, tr = ctx.cfg, ctx.traffic
    m = c["model"]
    st = State(ctx)
    if ctx.control != "fp8":
        from avsl_tpu_torch.cli.auto_avsr_ft import make_optimizer
        from avsl_tpu_torch.core.config import AutoAVSRConfig
        from avsl_tpu_torch.models import build_auto_avsr
        from avsl_tpu_torch.train import TrainState, make_train_step
        from avsl_tpu_torch.train.objectives import auto_avsr_loss_fn
    n = tr["pool"]
    pcm = data.audio(n, tr["seconds"], ctx.seed, ctx.device)
    frames = data.normalise(data.lip_frames(n, tr["frames"], m["image_crop_size"], ctx.seed,
                                            ctx.device))
    labels = data.label_ids(n, tr["labels"], m["odim"], ctx.seed)
    st.rows = [{"audio": pcm[i], "video": frames[i], "labels": labels[i]} for i in range(n)]
    st.order = data.order(n, n * 4096, ctx.seed)
    if ctx.control == "fp8":
        return st
    model = build_auto_avsr(AutoAVSRConfig.from_dict(m), device=ctx.device, seed=ctx.seed)
    model.load_state_dict(weights.make(ref_avsr.spec(m), ctx.seed, ctx.device))
    st.step = make_train_step(auto_avsr_loss_fn(model, train=True))
    t = c["train"]
    opt = make_optimizer(model, t["lr"], t["warmup_steps"], t["steps"])
    st.state = TrainState.create(model, opt, seed=ctx.seed)
    gc.collect()
    if ctx.control == "unchanged_state":
        def no_update(grads, grad_norm=None):
            opt.count += 1
        opt.step = no_update
    start = steps.host_copy(opt.params)
    losses = []
    for _ in range(tr["checked_updates"]):
        loss, _ = one_step(st)
        losses.append(loss)
        if opt.count == 1:
            st.got["grad_norms"] = steps.grad_norms(opt.names, opt)
    st.got["change_norms"] = steps.change_norms(opt.names, opt.params, start)
    st.got["losses"] = [float(x) for x in losses]
    return st


@contextlib.contextmanager
def _recording(on: bool):
    """The program's span record over the block when ``on``: a recording
    already open (``spanrun.py``'s) or one opened here; None when off or
    when the program records no spans."""
    try:
        from avsl_tpu_torch.utils import spans
    except ImportError:
        spans = None
    if not on or spans is None:
        yield None
    elif spans.current() is not None:
        yield spans.current()
    else:
        with spans.recording() as rec:
            yield rec


def window(st: State, seconds: float) -> Dict[str, Any]:
    if st.step is None:  # the fp8 control runs no program
        return {"end_to_end": {"train_segments_per_s": 0.0}, "attempted": 0, "failed": 0,
                "kind": "train", "segments": 0, "seconds": seconds, "model_ops": 0.0}
    st.ops = 0.0
    ran = []

    def one():
        loss, rows = one_step(st)
        ran.append((loss.detach(), rows))
        return rows, True

    with _recording(st.ctx.trace) as rec:
        done = steps.timed(one, seconds, st.ctx.device == "cuda")
    win = {"end_to_end": {"train_segments_per_s": done["segments"] / done["seconds"]},
           "attempted": done["segments"], "failed": steps.failed_rows(ran), "kind": "train",
           "model_ops": st.ops, **done}
    if rec is not None:
        win["spans"], win["counters"] = list(rec.spans), dict(rec.counters)
    return win


def micro_batch(st: State, idx: List[int]) -> Dict[str, torch.Tensor]:
    """The reference's tensors of the rows ``idx``, laid out as the CLI's
    collator lays them out (the pool's rows are all of one length)."""
    eos, dev = st.ctx.cfg["model"]["odim"] - 1, st.ctx.device
    rows = [st.rows[i] for i in idx]
    length = max(len(r["labels"]) for r in rows)
    targets = np.zeros((len(rows), length), np.int64)
    dec = np.full((len(rows), length + 1), eos, np.int64)
    labels = np.full((len(rows), length + 1), -100, np.int64)
    for i, r in enumerate(rows):
        n = len(r["labels"])
        targets[i, :n] = r["labels"]
        dec[i, 1: n + 1] = r["labels"]
        labels[i, :n] = r["labels"]
        labels[i, n] = eos

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return {"video": t(np.stack([r["video"] for r in rows])),
            "audio": t(np.stack([r["audio"] for r in rows])),
            "video_lengths": t(np.array([len(r["video"]) for r in rows], np.int64)),
            "audio_lengths": t(np.array([len(r["audio"]) for r in rows], np.int64)),
            "targets": t(targets), "target_lengths": t(np.array([len(r["labels"]) for r in rows])),
            "dec": t(dec), "labels": t(labels)}


def _run(P, st: State, mbs, keep_rows=None):
    m = st.ctx.cfg["model"]
    spec = ref_avsr.spec(m)
    W = weights.make(spec, st.ctx.seed, st.ctx.device)
    names = [n for n, _, kind in spec if kind not in ("mean", "var")]
    return ref_train.run(P, W, names,
                         lambda P_, W_, mb, gen, keep: ref_avsr.joint_loss(P_, W_, m, mb, gen,
                                                                           keep),
                         mbs, st.ctx.seed, st.ctx.traffic["checked_updates"],
                         optimizer(st.ctx.cfg), keep_rows)


def check(st: State) -> List[Dict[str, Any]]:
    ctx, tr = st.ctx, st.ctx.traffic
    count = tr["checked_updates"]
    if st.step is None:
        for _ in range(count):
            bs = ctx.cfg["train"]["batch_size"]
            st.fed.append([int(i) for i in st.order[st.used: st.used + bs]])
            st.used += bs
    st.step = st.state = None
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    precision.exact_fp32()
    mbs = [micro_batch(st, idx) for idx in st.fed[:count]]
    got = st.got if st.got else _run(precision.Precision("fp8"), st, mbs)
    want = _run(precision.Precision("fp32"), st, mbs)
    gaps = ref_train.compare(got, want)
    return [{"name": k, "value": v, "limit": ctx.limits[k]["limit"], "at": at}
            for k, (v, at) in gaps.items()]
