"""Offline audio-visual transcription through the port's
``infer/pipeline.py::StreamingTranscriber``, built as
``cli/_serving_common.py::build_transcriber`` builds it (greedy, the
traffic's batch, prefetch and new tokens; bf16 weights), with the
benchmark's weights loaded into it.

Traffic keys: ``pool`` items (PCM of ``audio_seconds``; a ``video_share``
of them carry ``frames`` normalised lip frames of ``crop`` x ``crop`` as
``lip_feats``, the rest none), ``batch_size``, ``max_new_tokens``,
``prefetch``, ``batches_per_call`` (each ``transcribe`` call gets that
many batches of items, drawn from the pool in seeded order) and
``check_requests`` (how many finished requests the check judges).

The window runs whole calls until ``seconds`` have passed and ends with
the last call that finished: ``transcribe_segments_per_s`` is the
segments it returned over the window's whole time. ``attempted`` counts
the items the calls were given, ``failed`` those that came back with no
result of their own id at their place; a run with any failed is not
correct. The check then frees the program, draws ``check_requests`` of
the finished requests from the seed, and runs the plain reference in
fp32 teacher-forced over each request's prompt and served tokens. It
reads ``served_gap``, the widest gap by which a served token's logit
lies below the reference's best, and ``logprob_gap``, the widest gap
between the mean log-probability of the served tokens that the
transcriber reports (``avg_logprob``) and the reference's. A cell's
limits file names the numbers it compares.

Control ``fp8``: the reference at fp8 in the program's place, on the
prompts and tokens the program served.
Control ``altered_token``: the served tokens of every finished request
shifted by one id where they are produced.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import data, flops, weights
from portbench.reference import precision, spec, whisper_flamingo as ref
from portbench.reference.audio import log_mel


@dataclass
class State:
    ctx: Any
    transcriber: Any = None
    prompt: List[int] = field(default_factory=list)
    eot: int = 0
    audio: np.ndarray = None
    video: np.ndarray = None
    has_video: np.ndarray = None
    served: List[tuple] = field(default_factory=list)
    next_index: int = 0


def _items(st: State, idx: np.ndarray) -> List[Dict[str, Any]]:
    out = []
    for i in idx:
        item = {"id": str(int(i)), "audio": st.audio[i]}
        if st.has_video[i]:
            item["lip_feats"] = st.video[i]
        out.append(item)
    return out


def build_program(cfg: dict, traffic: dict, sd: Dict[str, torch.Tensor], device, seed: int):
    from avsl_tpu_torch.data.tokenizer import get_tokenizer
    from avsl_tpu_torch.infer.pipeline import StreamingTranscriber
    from avsl_tpu_torch.models.factory import build_whisper_flamingo

    serving = cfg["serving"]
    tokenizer = get_tokenizer(None, serving["lang"])
    tokenizer.add_tokens(["<laugh>"])
    model, _ = build_whisper_flamingo(
        cfg["train"]["model_name"], vocab_size=cfg["whisper"]["n_vocab"], add_gated_x_attn=1,
        use_av_hubert_encoder=True, dtype=serving["dtype"], device=device, seed=seed)
    model.load_state_dict(sd)
    return StreamingTranscriber(
        model, tokenizer, audio_max_length=serving["audio_max_length"],
        video_frames=serving["video_frames"], crop=serving["crop"],
        batch_size=traffic["batch_size"], max_new_tokens=traffic["max_new_tokens"],
        beam_size=1, lang=serving["lang"], prefetch=traffic["prefetch"])


def setup(ctx) -> State:
    cfg, tr = ctx.cfg, ctx.traffic
    st = State(ctx)
    n = tr["pool"]
    serving = cfg["serving"]
    st.audio = data.audio(n, tr["audio_seconds"], ctx.seed, ctx.device)
    st.has_video = data.rng(ctx.seed, 5).permutation(
        np.arange(n) < int(round(tr["video_share"] * n)))
    frames = data.lip_frames(n, serving["video_frames"], serving["crop"], ctx.seed, ctx.device)
    st.video = data.normalise(frames)[..., None]
    del frames
    sd = weights.make(spec.whisper_flamingo(cfg), ctx.seed, ctx.device, gate=cfg["gate"],
                      bf16_values=True)
    st.transcriber = build_program(cfg, tr, sd, ctx.device, ctx.seed)
    del sd
    gc.collect()
    tok = st.transcriber.tokenizer
    st.prompt, st.eot = list(tok.sot_sequence(serving["lang"])), tok.eot
    # warm-up: one call of the window's size, then the window starts afresh
    st.transcriber.transcribe(_items(st, data.order(n, tr["batch_size"] * tr["batches_per_call"],
                                                    ctx.seed, stream=6)))
    return st


def window(st: State, seconds: float) -> Dict[str, Any]:
    tr = st.ctx.traffic
    per_call = tr["batch_size"] * tr["batches_per_call"]
    idx_stream = data.order(tr["pool"], per_call * 4096, st.ctx.seed)
    t0 = time.perf_counter()
    done, attempted, calls, ends = 0, 0, 0, []
    while True:
        idx = idx_stream[st.next_index: st.next_index + per_call]
        st.next_index += per_call
        results = st.transcriber.transcribe(_items(st, idx))
        calls += 1
        ends.append(time.perf_counter() - t0)
        attempted += len(idx)
        for i, r in zip(idx, results):
            if r.id == str(int(i)):
                st.served.append((int(i), list(r.tokens), float(r.avg_logprob)))
                done += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    if st.ctx.control == "altered_token":
        st.served = [(i, [(t + 1) % st.ctx.cfg["whisper"]["n_vocab"] for t in toks], lp)
                     for i, toks, lp in st.served]
    cfg, serving = st.ctx.cfg, st.ctx.cfg["serving"]
    t_mel = serving["audio_max_length"] // 160
    seg_ops = flops.transcribe_segment(cfg, t_mel, serving["video_frames"], serving["crop"],
                                       len(st.prompt), tr["max_new_tokens"])
    return {"end_to_end": {"transcribe_segments_per_s": done / elapsed},
            "attempted": attempted, "failed": attempted - done, "kind": "transcribe", "segments": done,
            "tokens": done * tr["max_new_tokens"], "seconds": elapsed, "calls": calls,
            "model_ops": done * seg_ops, "ends_s": ends}


def served_tokens(toks: List[int], eot: int) -> List[int]:
    """The served tokens up to and including the first EOT."""
    out = []
    for t in toks:
        out.append(int(t))
        if t == eot:
            break
    return out


def check(st: State) -> List[Dict[str, Any]]:
    ctx, cfg, tr = st.ctx, st.ctx.cfg, st.ctx.traffic
    st.transcriber = None
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    precision.exact_fp32()
    r = data.rng(ctx.seed, 7)
    pick = r.choice(len(st.served), size=min(tr["check_requests"], len(st.served)),
                    replace=False)
    longest = max(range(len(st.served)), key=lambda j: len(st.served[j][1]))
    if longest not in pick:
        pick[0] = longest
    W = weights.make(spec.whisper_flamingo(cfg), ctx.seed, ctx.device, gate=cfg["gate"],
                     bf16_values=True)
    worst = {"logprob_gap": (0.0, ""), "served_gap": (0.0, "")}
    n_tokens, block = 0, tr["check_block"]
    with torch.no_grad():
        for lo in range(0, len(pick), block):
            rows = [st.served[j] for j in pick[lo: lo + block]]
            for (i, toks, _), got in zip(rows, readings(W, cfg, st, rows)):
                n_tokens += got["tokens"]
                for k in worst:
                    if got[k] >= worst[k][0]:
                        worst[k] = (got[k], f"request of item {i}")
    del W
    return [{"name": k, "value": v, "limit": ctx.limits[k]["limit"],
             "at": f"{at}; {n_tokens} served tokens of {len(pick)} requests"}
            for k, (v, at) in worst.items() if k in ctx.limits]


def readings(W, cfg, st: State, rows) -> List[Dict[str, float]]:
    """Per row [(pool index, served tokens, avg_logprob)]: ``logprob_gap``,
    the gap between the mean log-probability of the served tokens (up to
    and including the first EOT) that the transcriber reported and the
    reference's, teacher-forced after the prompt; ``served_gap``, the
    widest gap by which a served token's logit lies below the reference's
    best. Under the ``fp8`` control the reference at fp8 takes the
    program's place on the same prompts and tokens: its mean
    log-probability, and the gap of the token it puts first."""
    dev = W["video_projection.weight"].device
    idx = [r[0] for r in rows]
    audio = torch.from_numpy(st.audio[idx]).to(dev)
    video = torch.from_numpy(np.where(st.has_video[idx][:, None, None, None, None],
                                      st.video[idx], 0.0)[..., 0]).to(dev)
    seqs = [served_tokens(r[1], st.eot) for r in rows]
    p = len(st.prompt)
    tokens = torch.full((len(rows), p + max(len(s) for s in seqs)), st.eot, dtype=torch.long)
    for b, s in enumerate(seqs):
        tokens[b, :p] = torch.tensor(st.prompt)
        tokens[b, p: p + len(s)] = torch.tensor(s)
    tokens = tokens.to(dev)
    mel = log_mel(audio, cfg["whisper"]["n_mels"])

    def logits_at(P):
        return ref.forward(P, W, cfg, mel, tokens, video, ref.Draws())

    want = logits_at(precision.Precision("fp32"))
    low = logits_at(precision.Precision("fp8")) if st.ctx.control == "fp8" else None
    out = []
    for b, s in enumerate(seqs):
        pos = slice(p - 1, p - 1 + len(s))
        ids = torch.tensor(s, device=dev)[:, None]
        ref_lp = torch.log_softmax(want[b, pos], dim=-1)
        if low is None:
            got_lp, picked = rows[b][2], ids
        else:
            low_lp = torch.log_softmax(low[b, pos], dim=-1)
            got_lp, picked = low_lp.gather(1, ids).mean().item(), low_lp.argmax(-1)[:, None]
        best = want[b, pos].max(dim=-1).values
        out.append({"logprob_gap": abs(got_lp - ref_lp.gather(1, ids).mean().item()),
                    "served_gap": (best - want[b, pos].gather(1, picked)[:, 0]).max().item(),
                    "tokens": len(s)})
    return out
