"""Batch transcription with host/device overlap (audio-only, greedy).

Port of ``StreamingTranscriber`` and ``TranscribeResult`` from
``avsl_tpu/infer/pipeline.py``. Per batch: log-mel -> Whisper encoder
(the flash-attention kernel in every block) -> decode cache with the
cross-attention K/V precomputed -> KV-cached greedy decode with the
mean token log-probability. ``transcribe`` prepares batch N+1 on a
producer thread while the device runs batch N.

Options of the JAX transcriber that belong to later slices raise
``NotImplementedError`` naming their ``ROADMAP.md`` item, as do items
that carry video.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from queue import Queue
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from avsl_tpu_torch.data.audio_segments import load_wav
from avsl_tpu_torch.decode.greedy import greedy_decode_scored
from avsl_tpu_torch.kernels.logmel import log_mel_spectrogram, pad_or_trim

_VIDEO_KEYS = ("lip_video", "video", "lip_feats")


@dataclass
class TranscribeResult:
    id: str
    text: str
    tokens: List[int]
    has_video: bool
    # mean token log-probability of the generated sequence (greedy)
    avg_logprob: float = 0.0


def _not_ported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported yet (ROADMAP.md queue 1, {item})"
    )


class StreamingTranscriber:
    """Greedy batch transcription of audio-only items.

    ``model`` is a :class:`~avsl_tpu_torch.models.Whisper` already on its
    device; batches run there. Audio is padded or trimmed to
    ``audio_max_length`` samples; a batch always holds ``batch_size`` rows.
    """

    def __init__(
        self,
        model,
        tokenizer,
        audio_max_length: int = 160000,
        batch_size: int = 8,
        max_new_tokens: int = 64,
        beam_size: int = 1,
        lang: str = "en",
        prefetch: int = 2,
        quantize: Optional[str] = None,
        kv_int8: bool = False,
        mesh: Optional[Any] = None,
        temperature_fallback: Sequence[float] = (),
        word_timestamps: bool = False,
        draft_model: Optional[Any] = None,
        draft_variables: Optional[Any] = None,
        boost_phrases: Optional[Sequence[str]] = None,
    ):
        refused = [
            (beam_size > 1, "beam_size>1", "item 9 (decode/beam.py)"),
            (quantize is not None, "quantize", "item 11 (models/quant.py)"),
            (bool(kv_int8), "kv_int8", "item 11 (models/quant.py)"),
            (mesh is not None, "mesh", "item 12 (the parallel layer)"),
            (bool(tuple(temperature_fallback)), "temperature_fallback",
             "item 11 (sampled fallback decode)"),
            (bool(word_timestamps), "word_timestamps",
             "item 11 (decode/word_timestamps.py)"),
            (draft_model is not None or draft_variables is not None, "draft_model",
             "item 11 (decode/speculative.py)"),
            (bool(boost_phrases), "boost_phrases", "item 11 (decode/biasing.py)"),
        ]
        for bad, option, item in refused:
            if bad:
                raise _not_ported(option, item)
        self.model = model
        self.tokenizer = tokenizer
        self.device = model.device
        self.audio_max_length = audio_max_length
        self.batch_size = batch_size
        self.max_new_tokens = max_new_tokens
        self.beam_size = beam_size
        self.lang = lang
        self.prefetch = prefetch
        sot = np.asarray(tokenizer.sot_sequence(lang), np.int64)
        self._prompt = torch.as_tensor(np.tile(sot[None], (batch_size, 1)), device=self.device)

    @torch.inference_mode()
    def _run(self, audio: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Device program for one padded batch: [B, samples] float32 ->
        (tokens [B, max_new_tokens], avg_logprob [B])."""
        model, cfg = self.model, self.model.cfg
        x = torch.from_numpy(audio).to(self.device, non_blocking=True)
        mel = log_mel_spectrogram(x, n_mels=cfg.n_mels)
        feats, xv = model.encode(mel)
        cache_len = self.max_new_tokens + self._prompt.shape[1] + 2
        cache = model.init_decode_cache(feats, xv, cache_len)

        def step(tok, c):
            return model.decode(tok, None, None, c)

        seqs, scores = greedy_decode_scored(
            step, cache, self._prompt, self.max_new_tokens, self.tokenizer.eot
        )
        return seqs.cpu().numpy(), scores.cpu().numpy()

    # -- host side -----------------------------------------------------

    def _load_item(self, item: Dict[str, Any]) -> Tuple[np.ndarray, int]:
        for key in _VIDEO_KEYS:
            if item.get(key) is not None:
                raise NotImplementedError(
                    f"item {item.get('id')!r} carries {key!r}: video inputs are "
                    "slice 3 of the port (ROADMAP.md queue 1, items 6-7)"
                )
        audio = load_wav(item["audio"]) if isinstance(item["audio"], str) else item["audio"]
        n_samples = min(len(audio), self.audio_max_length)
        audio = pad_or_trim(np.asarray(audio, np.float32), self.audio_max_length)
        return audio, n_samples

    def _prepare_batch(self, items: Sequence[Dict[str, Any]]) -> np.ndarray:
        audio = np.zeros((self.batch_size, self.audio_max_length), np.float32)
        for i, item in enumerate(items):
            audio[i], _ = self._load_item(item)
        return audio

    def _results(self, chunk, seqs, scores, first_index: int) -> List[TranscribeResult]:
        special = self.tokenizer.special_token_set
        results = []
        for i in range(len(chunk)):
            toks = [int(x) for x in seqs[i]]
            text_ids = [x for x in toks if x not in special]
            results.append(
                TranscribeResult(
                    id=str(chunk[i].get("id", first_index + i)),
                    text=self.tokenizer.decode(text_ids).strip(),
                    tokens=toks,
                    has_video=False,
                    avg_logprob=round(float(scores[i]), 4),
                )
            )
        return results

    # -- public API ----------------------------------------------------

    def transcribe_batch(self, items: Sequence[Dict[str, Any]]) -> List[TranscribeResult]:
        """Synchronously transcribe ONE batch (<= batch_size items)."""
        if not items:
            return []
        if len(items) > self.batch_size:
            raise ValueError(f"{len(items)} items > batch_size {self.batch_size}")
        chunk = list(items)
        seqs, scores = self._run(self._prepare_batch(chunk))
        return self._results(chunk, seqs, scores, 0)

    def transcribe(self, items: Sequence[Dict[str, Any]]) -> List[TranscribeResult]:
        """Items: dicts with 'id' and 'audio' (path or array). Returns
        per-item results in order; host loading of the next batch
        overlaps the device work of the current one."""
        batches = [
            items[i : i + self.batch_size]
            for i in range(0, len(items), self.batch_size)
        ]
        queue: Queue = Queue(maxsize=self.prefetch)

        def producer():
            # a load failure must reach the consumer, or it would block on
            # queue.get() forever
            try:
                for chunk in batches:
                    queue.put((chunk, self._prepare_batch(chunk)))
                queue.put(None)
            except Exception as e:  # re-raised by the consumer
                queue.put(("__producer_error__", e))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        results: List[TranscribeResult] = []
        while True:
            got = queue.get()
            if got is None:
                break
            if got[0] == "__producer_error__":
                t.join()
                raise got[1]
            chunk, audio = got
            seqs, scores = self._run(audio)
            results.extend(self._results(chunk, seqs, scores, len(results)))
        t.join()
        return results
