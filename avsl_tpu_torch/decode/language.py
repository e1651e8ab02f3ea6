"""Whisper language identification: one decode step from ``<|sot|>``.

Port of ``avsl_tpu/decode/language.py``. The distribution over the
language tokens right after ``<|sot|>`` is the language posterior; one
encoder pass (the flash-attention kernel in every block) and one decode
step give it for a whole batch.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from avsl_tpu_torch.data.tokenizer import WHISPER_ALL_LANGS, WHISPER_LANGS
from avsl_tpu_torch.kernels.logmel import log_mel_spectrogram


def detect_language_logits(model, mel: torch.Tensor, sot_id: int,
                           lang_token_ids: torch.Tensor) -> torch.Tensor:
    """Encode ``mel`` [B, n_mels, T] (audio only), decode one step from
    ``<|sot|>`` and gather the logits of ``lang_token_ids`` [L]. Returns
    [B, L] fp32."""
    feats, _ = model.encode(mel, None)
    cache = model.init_decode_cache(feats, None, 4)
    sot = torch.full((mel.shape[0], 1), sot_id, dtype=torch.int64, device=mel.device)
    logits, _ = model.decode(sot, None, None, cache)
    return logits[:, -1].float()[:, lang_token_ids.to(mel.device)]


def language_token_ids(tokenizer) -> Tuple[List[str], List[int]]:
    """The tokenizer's languages, in the JAX package's order, and their
    token ids."""
    langs = [l for l in (*WHISPER_ALL_LANGS, *WHISPER_LANGS)
             if f"<|{l}|>" in tokenizer.special_tokens]
    langs = list(dict.fromkeys(langs))  # ordered dedup
    if not langs:
        raise ValueError("tokenizer has no language tokens")
    return langs, [tokenizer.special_tokens[f"<|{l}|>"] for l in langs]


@torch.inference_mode()
def detect_language(model, tokenizer, audio) -> List[Tuple[str, Dict[str, float]]]:
    """Spoken language of each clip in ``audio`` [B, S] (16 kHz float PCM,
    an array or a tensor), on the model's device and in eval mode (the
    caller's mode is restored). Returns per clip ``(best_lang, {lang:
    prob})``, the probabilities normalised over the tokenizer's languages."""
    langs, ids = language_token_ids(tokenizer)
    device = model.device
    was_training = model.training
    model.eval()
    try:
        x = torch.as_tensor(np.asarray(audio, np.float32) if not isinstance(audio, torch.Tensor)
                            else audio).to(device)
        mel = log_mel_spectrogram(x, n_mels=model.cfg.n_mels)
        logits = detect_language_logits(model, mel, int(tokenizer.sot),
                                        torch.tensor(ids, dtype=torch.int64))
        probs = torch.softmax(logits, dim=-1).cpu().numpy()
    finally:
        model.train(was_training)
    out = []
    for row in probs:
        table = {l: float(p) for l, p in zip(langs, row)}
        out.append((max(table, key=table.get), table))
    return out
