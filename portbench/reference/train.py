"""Fine-tuning steps in plain PyTorch, and the numbers the training check
compares.

:func:`run` takes any loss over fp32 weights: accumulation of ``accum``
micro-batches by their running mean (optax ``MultiSteps``), then
global-norm clipping and AdamW with a linear warmup that starts at 0
(optax ``chain(clip_by_global_norm, adamw)``, the update count read
before its increment), every random draw from one generator seeded as
the program's.

Whisper-Flamingo (:func:`flamingo_run`): the Flamingo regime (only the
gated sublayers, their norms and gates and the video projection train),
token-mean cross-entropy; each micro-step draws, in this order,
SpecAugment (:func:`~portbench.reference.audio.spec_augment`), one AV-mode
draw (audio-only when it falls in ``[prob_av, prob_av + prob_a)``,
video-only past that), then the forward's dropout masks and LayerDrop
draws (:class:`~portbench.reference.whisper_flamingo.Draws`); the video
tower's BatchNorm normalises each micro-batch by its own statistics.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference import audio as ref_audio
from portbench.reference import tokens as ref_tokens
from portbench.reference import whisper_flamingo as ref
from portbench.reference.precision import Precision
from portbench.reference.spec import trained


def schedule(lr: float, warmup: int, total: int, count: int) -> float:
    """Linear warmup from 0 to ``lr`` over ``warmup`` updates, then linear
    decay to 0 at ``total``."""
    warm = max(warmup, 1)
    if count < warm:
        return float(np.float32(lr) * np.float32(count) / np.float32(warm))
    decay = max(total - warmup, 1)
    return float(np.float32(lr) * (np.float32(1.0) - np.float32(min(count - warm, decay))
                                   / np.float32(decay)))


def flamingo_optimizer(cfg: dict) -> dict:
    tc = cfg["train"]
    return {"b2": tc["adam_beta2"], "eps": tc["adam_epsilon"], "weight_decay": tc["weight_decay"],
            "clip_norm": tc["clip_norm"], "accum": tc["gradient_accumulation_steps"],
            "lr": lambda count: schedule(tc["learning_rate"], tc["warmup_steps"],
                                         tc["num_train_steps"], count)}


def micro_batch(cfg: dict, rows: List[dict], device) -> Dict[str, torch.Tensor]:
    """The tensors of one micro-batch from raw rows (``audio`` float32 PCM,
    ``text``, ``frames`` uint8 lip frames [T, H, W])."""
    tc = cfg["train"]
    n = tc["audio_max_length"]
    pcm = np.zeros((len(rows), n), np.float32)
    frames = np.zeros((len(rows),), np.int64)
    for i, r in enumerate(rows):
        a = np.asarray(r["audio"], np.float32)[:n]
        pcm[i, : len(a)] = a
        frames[i] = len(r["audio"]) // 160
    length = min(tc["text_max_length"], cfg["whisper"]["n_text_ctx"])
    dec, lab = ref_tokens.batch([r["text"] for r in rows], length)
    video = np.stack([(np.asarray(r["frames"], np.float32) / 255.0 - 0.421) / 0.165
                      for r in rows])
    return {"audio": torch.from_numpy(pcm).to(device), "frames": torch.from_numpy(frames),
            "dec": torch.from_numpy(dec).to(device), "labels": torch.from_numpy(lab).to(device),
            "video": torch.from_numpy(video).to(device)}


def loss_of(P: Precision, W, cfg: dict, mb: Dict[str, torch.Tensor],
            generator: torch.Generator, keep_rows: Optional[int] = None) -> torch.Tensor:
    tc = cfg["train"]
    mel = ref_audio.log_mel(mb["audio"], cfg["whisper"]["n_mels"])
    if tc["spec_augment"] == "ls-basic":
        mel = ref_audio.spec_augment(mel, mb["frames"], generator, 1, 1)
    scale = 1.0
    if tc["prob_use_av"] < 1.0 or tc["prob_use_a"] > 0.0:
        u = torch.rand((), generator=generator, device=mel.device)
        lo, hi = tc["prob_use_av"], tc["prob_use_av"] + tc["prob_use_a"]
        audio_only = bool((u >= lo) & (u < hi))
        scale = 0.0 if audio_only else 1.0
        mel = mel * float(u < hi)
    draws = ref.Draws(generator, train=True)
    dec, labels, video = mb["dec"], mb["labels"], mb["video"]
    if keep_rows is not None:
        mel, dec, labels, video = mel[:keep_rows], dec[:keep_rows], labels[:keep_rows], \
            video[:keep_rows]
    logits = _forward_scaled(P, W, cfg, mel, dec, video, draws, scale)
    valid = labels != -100
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    return (nll * valid).sum() / valid.sum().clamp(min=1)


def _forward_scaled(P, W, cfg, mel, dec, video, draws, scale):
    w = cfg["whisper"]
    rate = cfg["train"]["dropout_rate"]
    with torch.no_grad():
        feats = ref.whisper_encoder(P, W, w, mel, draws, rate)
        v = ref.video_tower(P, W, cfg["video_tower"], video, draws,
                            torch.ones(video.shape[:2], dtype=torch.bool, device=video.device))
    xv = ref.linear(P, v, W, "video_projection") * scale
    return ref.whisper_decoder(P, W, w, dec, feats, xv, draws, rate)


def run(P: Precision, W: Dict[str, torch.Tensor], names: List[str], loss_fn,
        micro_batches: List[dict], seed: int, updates: int, opt: dict,
        keep_rows: Optional[int] = None) -> Dict[str, object]:
    """``updates`` optimizer steps of ``opt["accum"]`` micro-batches each
    from the weights ``W``, training the tensors ``names`` in place;
    ``loss_fn(P, W, micro_batch, generator, keep_rows)``. Returns the loss
    of every micro-step, each trained tensor's norm of the first update's
    clipped gradient, and its norm of change after the last update.
    ``keep_rows``: each micro-batch cut to its first rows (a planted
    fault: half the batch left out)."""
    accum = opt["accum"]
    start = {n: W[n].detach().clone() for n in names}
    for n in names:
        W[n].requires_grad_(True)
    gen = torch.Generator(device=W[names[0]].device)
    gen.manual_seed(int(seed))
    acc = [torch.zeros_like(W[n]) for n in names]
    mu = [torch.zeros_like(W[n]) for n in names]
    nu = [torch.zeros_like(W[n]) for n in names]
    b1, b2, eps = 0.9, opt["b2"], opt["eps"]
    losses, first_grad = [], None
    for u in range(updates):
        for k in range(accum):
            loss = loss_fn(P, W, micro_batches[u * accum + k], gen, keep_rows)
            grads = torch.autograd.grad(loss, [W[n] for n in names], allow_unused=True)
            losses.append(float(loss.detach()))
            with torch.no_grad():
                for a, g in zip(acc, grads):
                    if g is not None:
                        a.add_((g - a) / (k + 1))
                    else:
                        a.mul_(k / (k + 1))
        with torch.no_grad():
            norm = torch.sqrt(sum(a.square().sum() for a in acc))
            clip = opt["clip_norm"]
            factor = clip / norm if norm >= clip else torch.ones_like(norm)
            g = [a * factor for a in acc]
            if first_grad is None:
                first_grad = {n: float(t.norm()) for n, t in zip(names, g)}
            count = u + 1
            bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
            lr = opt["lr"](u)
            for n, gi, m, v in zip(names, g, mu, nu):
                m.mul_(b1).add_(gi, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(gi, gi, value=1.0 - b2)
                upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) + opt["weight_decay"] * W[n]
                W[n].sub_(lr * upd)
            for a in acc:
                a.zero_()
    change = {n: float((W[n].detach() - start[n]).norm()) for n in names}
    for n in names:
        W[n].requires_grad_(False)
    return {"losses": losses, "grad_norms": first_grad, "change_norms": change}


def flamingo_run(P: Precision, W: Dict[str, torch.Tensor], cfg: dict, micro_batches, seed: int,
                 updates: int, keep_rows: Optional[int] = None) -> Dict[str, object]:
    """:func:`run` under the Flamingo regime and the training YAML's optimizer."""
    return run(P, W, [n for n in W if trained(n)],
               lambda P_, W_, mb, gen, keep: loss_of(P_, W_, cfg, mb, gen, keep),
               micro_batches, seed, updates, flamingo_optimizer(cfg), keep_rows)


def compare(got: Dict[str, object], want: Dict[str, object]) -> Dict[str, tuple]:
    """The three numbers the training check holds to their limits, each
    with where it was read: ``loss_gap`` the worst relative gap of a
    micro-step's loss; ``grad_gap`` and ``change_gap`` the worst leaf's
    gap between the two sides' norms of the first clipped gradient and of
    the change after the last update, over the larger of that leaf's
    reference norm and the median leaf's. The change leaves out the leaves
    whose reference gradient is under a thousandth of the median leaf's:
    their change is round-off that Adam scales to a step."""
    loss = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]
    worst_step = int(np.argmax(loss))

    def worst(key, names):
        med = float(np.median([want[key][n] for n in names]))
        gaps = {n: abs(got[key][n] - want[key][n]) / max(want[key][n], med, 1e-30)
                for n in names}
        leaf = max(gaps, key=gaps.get)
        return gaps[leaf], leaf

    names = list(want["grad_norms"])
    med_grad = float(np.median([want["grad_norms"][n] for n in names]))
    moving = [n for n in names if want["grad_norms"][n] >= 1e-3 * med_grad]
    return {"loss_gap": (loss[worst_step], f"micro-step {worst_step + 1}"),
            "grad_gap": worst("grad_norms", names),
            "change_gap": worst("change_norms", moving)}
