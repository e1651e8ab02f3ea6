"""AV-HuBERT sequence-to-sequence fine-tuning through the port's
``cli/avhubert_ft.py``: ``build_avhubert`` with the configuration's model
card, the CLI's optimizer (``make_optimizer``), ``make_train_step`` over
``avhubert_seq2seq_loss_fn`` and batches collated by the CLI's
``collate_av``, in the order of its ``batches()`` (seeded permutations of
the rows); the benchmark's weights are loaded into the model.

Traffic keys: ``pool`` rows of ``frames`` audio-feature frames (104-dim,
normalised) and lip frames (88 x 88), labels (``labels``: the range of
their lengths) cut at ``max_label_len``; ``checked_updates``. The batch
is the configuration's ``train.batch_size``.

Set-up takes ``checked_updates`` steps through the window's call and
feed, on rows that all differ, and keeps each step's loss, each
tensor's first clipped gradient norm and its change after the last; the
window continues the same state; the check frees the program and runs
the plain reference (:mod:`portbench.reference.avhubert`) through the
same steps. Controls as for ``finetune_flamingo``: ``fp8``,
``half_batch``, ``unchanged_state``.
"""

from __future__ import annotations

import gc
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import data, flops, steps, weights
from portbench.reference import avhubert as ref_avh
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


def optimizer(c: dict) -> dict:
    t = c["train"]
    return {"b2": 0.98, "eps": 1e-6, "weight_decay": 0.01, "clip_norm": 10.0, "accum": 1,
            "lr": lambda count: ref_train.schedule(t["lr"], max(t["steps"] // 10, 1), t["steps"],
                                                   count)}


def _next_batch(st: State):
    from avsl_tpu_torch.cli.avhubert_ft import collate_av

    bs = st.ctx.cfg["train"]["batch_size"]
    idx = [int(i) for i in st.order[st.used: st.used + bs]]
    st.used += bs
    st.fed.append(idx)
    return collate_av([st.rows[i] for i in idx], st.ctx.cfg["model"]["pad_token_id"],
                      max_label_len=st.ctx.traffic["max_label_len"])


def one_step(st: State):
    batch = _next_batch(st)
    rows = len(batch["labels"])
    if st.ctx.control == "half_batch":
        batch = {k: v[: rows // 2] for k, v in batch.items()}
    st.state, metrics = st.step(st.state, batch)
    st.ops += len(batch["labels"]) * flops.avhubert_train_segment(
        st.ctx.cfg["model"], batch["audio"].shape[1], batch["labels"].shape[1])
    return metrics["loss"], rows


def setup(ctx) -> State:
    c, tr = ctx.cfg, ctx.traffic
    m = c["model"]
    st = State(ctx)
    n = tr["pool"]
    feats = data.features(n, tr["frames"], m["audio_feat_dim"], ctx.seed, ctx.device)
    frames = data.normalise(data.lip_frames(n, tr["frames"], m["image_crop_size"], ctx.seed,
                                            ctx.device))[..., None]
    labels = data.label_ids(n, tr["labels"], m["vocab_size"], ctx.seed)
    st.rows = [{"audio_feats": feats[i], "video_feats": frames[i], "labels": labels[i]}
               for i in range(n)]
    st.order = data.order(n, n * 4096, ctx.seed)
    if ctx.control == "fp8":
        return st
    from avsl_tpu_torch.cli.avhubert_ft import make_optimizer
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.models import build_avhubert
    from avsl_tpu_torch.train import TrainState, make_train_step
    from avsl_tpu_torch.train.objectives import avhubert_seq2seq_loss_fn

    model = build_avhubert(AVHuBERTConfig(**m), "seq2seq", device=ctx.device, seed=ctx.seed)
    model.load_state_dict(weights.make(ref_avh.spec(m), ctx.seed, ctx.device))
    st.step = make_train_step(avhubert_seq2seq_loss_fn(model, train=True))
    opt = make_optimizer(model, c["train"]["lr"], c["train"]["steps"])
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

    done = steps.timed(one, seconds, st.ctx.device == "cuda")
    return {"end_to_end": {"train_segments_per_s": done["segments"] / done["seconds"]},
            "attempted": done["segments"], "failed": steps.failed_rows(ran), "kind": "train",
            "model_ops": st.ops, **done}


def micro_batch(st: State, idx: List[int]) -> Dict[str, torch.Tensor]:
    """The reference's tensors of the rows ``idx``, laid out as the CLI's
    collator lays them out: labels EOS-terminated (id 2) and cut, -100
    past them; decoder inputs BOS (id 0) then the labels shifted right,
    ``pad`` past them."""
    m, dev = st.ctx.cfg["model"], st.ctx.device
    rows = [st.rows[i] for i in idx]
    length = min(max(len(r["labels"]) + 1 for r in rows), st.ctx.traffic["max_label_len"])
    labels = np.full((len(rows), length), -100, np.int64)
    dec = np.full((len(rows), length), m["pad_token_id"], np.int64)
    for i, r in enumerate(rows):
        ids = (r["labels"] + [m["eos_token_id"]])[:length]
        labels[i, : len(ids)] = ids
        dec[i, 0] = m["bos_token_id"]
        dec[i, 1: len(ids)] = ids[:-1]
    t = max(len(r["audio_feats"]) for r in rows)
    return {"audio": torch.from_numpy(np.stack([r["audio_feats"] for r in rows])).to(dev),
            "video": torch.from_numpy(np.stack([r["video_feats"][..., 0] for r in rows])).to(dev),
            "valid": torch.ones((len(rows), t), dtype=torch.bool, device=dev),
            "dec": torch.from_numpy(dec).to(dev), "labels": torch.from_numpy(labels).to(dev)}


def _run(P, st: State, mbs, keep_rows=None):
    m = st.ctx.cfg["model"]
    spec = ref_avh.spec(m)
    W = weights.make(spec, st.ctx.seed, st.ctx.device)
    names = [n for n, _, kind in spec if kind not in ("mean", "var")]
    return ref_train.run(P, W, names,
                         lambda P_, W_, mb, gen, keep: ref_avh.seq2seq_loss(P_, W_, m, mb, gen,
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
