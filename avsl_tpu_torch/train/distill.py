"""Draft-model distillation for speculative decoding.

Port of ``avsl_tpu/train/distill.py``: a small audio-only Whisper draft
learns the target's teacher-forced next-token distributions along the
target's own greedy decodes of unlabelled audio (self-labelling), the
distribution speculative decoding queries the draft on.

* :func:`make_greedy_label_fn` decodes a batch greedily with the target
  (``cli/distill.py`` runs it once per clip and keeps the tokens);
  :func:`make_label_fn` also returns the target's teacher-forced
  log-probabilities and the trained positions (:func:`valid_positions`).
  Both run under ``no_grad``, the target in eval mode.
* :func:`distill_loss_fn` is KL(target || draft) plus ``hard_weight`` x CE on
  the target's greedy tokens, both over the valid positions, with the
  masked argmax agreement ``agree`` (the offline proxy of the acceptance
  rate). The draft runs deterministically (eval mode) with gradients.
* :func:`make_online_distill_step` recomputes the target's distribution
  in one forward without gradients each step, then updates the draft
  through the state's optimizer (``train/optim.py::constant_adamw`` is
  ``optax.adamw``); :func:`make_distill_step` takes cached
  log-probabilities. The optimizer lives in the state, so neither takes
  JAX's ``tx``.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from avsl_tpu_torch.kernels.logmel import log_mel_spectrogram
from avsl_tpu_torch.train.loop import TrainState


def _audio(audio, device) -> torch.Tensor:
    """Waveforms [B, S] as an fp32 tensor on ``device``."""
    if not isinstance(audio, torch.Tensor):
        audio = torch.from_numpy(np.asarray(audio, np.float32))
    return audio.to(device, torch.float32)


def _greedy(target, audio, prompt, max_new_tokens: int, eot_id: int):
    """(tokens [B, P+N], encoder features): the target's greedy
    continuation of ``prompt``."""
    from avsl_tpu_torch.decode.greedy import greedy_decode

    device = target.device
    mel = log_mel_spectrogram(_audio(audio, device), n_mels=target.cfg.n_mels)
    feats, _ = target.encode(mel)
    prompt = torch.as_tensor(np.asarray(prompt), device=device).long()
    cache = target.init_decode_cache(feats, None, prompt.shape[1] + max_new_tokens + 2)
    gen = greedy_decode(lambda tok, c: target.decode(tok, None, cache=c), cache, prompt,
                        max_new_tokens, eot_id)
    return torch.cat([prompt, gen.to(prompt.dtype)], dim=1), feats


def make_greedy_label_fn(target_model, max_new_tokens: int, eot_id: int) -> Callable:
    """``label_fn(audio [B, S], prompt [B, P]) -> tokens [B, P+N]``: the
    target's greedy decode, without gradients, the target in eval mode."""

    @torch.no_grad()
    def label_fn(audio, prompt):
        target_model.eval()
        return _greedy(target_model, audio, prompt, max_new_tokens, eot_id)[0]

    return label_fn


def make_label_fn(target_model, max_new_tokens: int, eot_id: int) -> Callable:
    """``label_fn(audio, prompt) -> (tokens [B, P+N], t_logprob [B, P-1+N,
    V] fp32, valid [B, P-1+N])``: the greedy continuation, the target's
    teacher-forced log-probabilities along it, and the positions a draft
    is trained on."""

    @torch.no_grad()
    def label_fn(audio, prompt):
        target_model.eval()
        tokens, feats = _greedy(target_model, audio, prompt, max_new_tokens, eot_id)
        logits, _ = target_model.decode(tokens[:, :-1], feats)
        t_logprob = torch.log_softmax(logits.float(), dim=-1)
        return tokens, t_logprob, valid_positions(tokens, np.shape(prompt)[1], eot_id)

    return label_fn


def valid_positions(tokens: torch.Tensor, prompt_len: int, eot_id: int) -> torch.Tensor:
    """The trained positions of a labelled sequence [B, P+N]: those that
    predict a generated token (``>= P - 1``) up to and including the one
    that predicts the first EOT. [B, P+N-1] bool."""
    pred = tokens[:, 1:]
    is_eot = (pred == eot_id).long()
    eot_before = torch.cumsum(is_eot, dim=1) - is_eot
    pos = torch.arange(pred.shape[1], device=tokens.device)[None, :]
    return (pos >= prompt_len - 1) & (eot_before == 0)


def distill_loss_fn(draft_model, audio, tokens: torch.Tensor, t_logprob: torch.Tensor,
                    valid: torch.Tensor, hard_weight: float = 0.5
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """KL(target || draft) + ``hard_weight`` x CE on the target's greedy
    tokens, each summed over the ``valid`` positions over their count (at
    least 1); metrics ``loss``, ``kl``, ``ce`` and ``agree`` (the masked
    share of positions where the two argmaxes agree)."""
    mel = log_mel_spectrogram(_audio(audio, tokens.device), n_mels=draft_model.cfg.n_mels)
    feats, _ = draft_model.encode(mel)
    logits, _ = draft_model.decode(tokens[:, :-1], feats)
    d_logprob = torch.log_softmax(logits.float(), dim=-1)
    t_logprob = t_logprob.detach()
    w = valid.float()
    denom = torch.clamp(w.sum(), min=1.0)
    kl = (torch.exp(t_logprob) * (t_logprob - d_logprob)).sum(-1)
    kl = (kl * w).sum() / denom
    ce = -torch.gather(d_logprob, -1, tokens[:, 1:, None].long())[..., 0]
    ce = (ce * w).sum() / denom
    agree = (d_logprob.argmax(-1) == t_logprob.argmax(-1)).float()
    agree = (agree * w).sum() / denom
    loss = kl + hard_weight * ce
    return loss, {"loss": loss.detach(), "kl": kl.detach(), "ce": ce.detach(),
                  "agree": agree.detach()}


def _update(state: TrainState, loss: torch.Tensor) -> TrainState:
    """Backward, one optimizer update of the draft's trained tensors,
    gradients cleared."""
    loss.backward()
    opt = state.optimizer
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in opt.params]
    opt.step(grads)
    for p in state.model.parameters():
        p.grad = None
    state.step += 1
    return state


def make_online_distill_step(target_model, draft_model, prompt_len: int, eot_id: int,
                             hard_weight: float = 0.5) -> Callable:
    """``step(state, audio, tokens) -> (state, metrics)``: the target's
    teacher-forced log-probabilities along the cached greedy labels in one
    forward without gradients, then :func:`distill_loss_fn` and one update
    of ``state`` (the draft and its optimizer)."""

    def step_fn(state: TrainState, audio, tokens):
        device = target_model.device
        tokens = torch.as_tensor(np.asarray(tokens), device=device).long()
        target_model.eval()
        with torch.no_grad():
            mel = log_mel_spectrogram(_audio(audio, device), n_mels=target_model.cfg.n_mels)
            feats, _ = target_model.encode(mel)
            logits, _ = target_model.decode(tokens[:, :-1], feats)
            t_logprob = torch.log_softmax(logits.float(), dim=-1)
            del logits, feats
        valid = valid_positions(tokens, prompt_len, eot_id)
        draft_model.eval()
        loss, metrics = distill_loss_fn(draft_model, audio, tokens, t_logprob, valid,
                                        hard_weight=hard_weight)
        return _update(state, loss), metrics

    return step_fn


def make_distill_step(draft_model, hard_weight: float = 0.5) -> Callable:
    """``step(state, audio, tokens, t_logprob, valid) -> (state, metrics)``
    on log-probabilities already computed (:func:`make_label_fn`)."""

    def step_fn(state: TrainState, audio, tokens, t_logprob, valid):
        draft_model.eval()
        loss, metrics = distill_loss_fn(draft_model, audio, tokens, t_logprob, valid,
                                        hard_weight=hard_weight)
        return _update(state, loss), metrics

    return step_fn
