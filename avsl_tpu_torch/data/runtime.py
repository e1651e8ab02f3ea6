"""Runtime dataset + collator: dataset rows -> model-ready batches.

Port of ``AmiVideoDataset`` (audio only) and ``WhisperVideoCollator``
from ``avsl_tpu/data/runtime.py``. Per item: 16 kHz float audio,
``pad_or_trim`` to the configured length, log-mel on the host CPU,
jiwer-style text normalisation, and the Whisper SOT sequence + tokens
with shifted labels + EOT. SpecAugment runs on the device inside the train
step (``kernels/specaugment.py``). Lip video (``load_video=True``) is slice
3 of the port and raises; audio at another rate than 16 kHz raises until
the resampler is ported (ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence

import numpy as np

from avsl_tpu_torch.data.audio_segments import load_wav, pcm_to_float
from avsl_tpu_torch.data.tokenizer import Tokenizer
from avsl_tpu_torch.decode.text_norm import normalize_text


def _resample_not_ported(sr: int, target_sr: int) -> NotImplementedError:
    return NotImplementedError(
        f"sample rate {sr} != {target_sr}: resampling waits for the port of "
        "kernels/resample.py (ROADMAP.md queue 1, item 7)"
    )


def _extract_audio(item: Dict[str, Any], target_sr: int = 16000) -> np.ndarray:
    """Dataset 'audio' value (dict with an array or wav bytes, or a path)
    -> mono float32 at ``target_sr``."""
    audio = item.get("audio")
    if isinstance(audio, dict) and audio.get("array") is not None:
        # normalise before any float cast: integer PCM is rescaled
        data = pcm_to_float(audio["array"])
        sr = int(audio.get("sampling_rate", target_sr))
    elif isinstance(audio, dict) and audio.get("bytes") and not (
        audio.get("path") and os.path.exists(audio["path"])
    ):
        import io

        import scipy.io.wavfile as wavfile

        sr, data = wavfile.read(io.BytesIO(audio["bytes"]))
        data = pcm_to_float(data)
    else:
        path = audio.get("path") if isinstance(audio, dict) else audio
        return load_wav(path, target_sr)
    if sr != target_sr:
        raise _resample_not_ported(sr, target_sr)
    return data.astype(np.float32)


class AmiVideoDataset:
    """Per-item example builder over a dataset / record list (audio only)."""

    def __init__(
        self,
        hf_dataset,
        tokenizer: Tokenizer,
        audio_max_length: int = 160000,
        n_mels: int = 80,
        lang: str = "en",
        sample_rate: int = 16000,
        load_video: bool = True,
    ):
        if load_video:
            raise NotImplementedError(
                "load_video=True: lip video is slice 3 of the port "
                "(ROADMAP.md queue 1, items 6-7); pass load_video=False"
            )
        self.ds = hf_dataset
        self.tokenizer = tokenizer
        self.audio_max_length = audio_max_length
        self.n_mels = n_mels
        self.lang = lang
        self.sample_rate = sample_rate

    def __len__(self) -> int:
        return len(self.ds)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        from avsl_tpu_torch.kernels.logmel import log_mel_spectrogram, pad_or_trim

        item = self.ds[idx]
        audio = _extract_audio(item, self.sample_rate)
        audio_frames = len(audio) // (self.sample_rate // 100)
        audio = np.asarray(pad_or_trim(audio, self.audio_max_length), np.float32)
        mel = log_mel_spectrogram(audio, n_mels=self.n_mels, device="cpu").numpy()

        text = normalize_text(str(item.get("transcript", "")))
        toks = self.tokenizer.prepare_example(text, self.lang)
        return {
            "input_ids": mel.astype(np.float32),  # [n_mels, T]
            "dec_input_ids": np.asarray(toks["dec_input_ids"], np.int64),
            "labels": np.asarray(toks["labels"], np.int64),
            "audio_frames": audio_frames,
        }


class WhisperVideoCollator:
    """Pad a list of items to one batch.

    labels are padded with -100 (CE ignore), dec_input_ids with EOT;
    ``label_pad_len`` may pin the padded length and ``max_label_len`` caps
    it (text_max_length / n_text_ctx). Items with video, and the video
    padding the JAX collator takes, are slice 3."""

    def __init__(self, eot_id: int, label_pad_len: Optional[int] = None,
                 max_label_len: Optional[int] = None):
        self.eot_id = eot_id
        self.label_pad_len = label_pad_len
        self.max_label_len = max_label_len

    def __call__(self, items: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        if "video" in items[0]:
            raise NotImplementedError(
                "items with video: lip video is slice 3 of the port (ROADMAP.md queue 1, items 6-7)"
            )
        batch: Dict[str, np.ndarray] = {"input_ids": np.stack([it["input_ids"] for it in items])}
        lab_len = self.label_pad_len or max(len(it["labels"]) for it in items)
        if self.max_label_len is not None:
            lab_len = min(lab_len, self.max_label_len)
        labels = np.full((len(items), lab_len), -100, np.int64)
        dec = np.full((len(items), lab_len), self.eot_id, np.int64)
        for i, it in enumerate(items):
            n = min(len(it["labels"]), lab_len)
            labels[i, :n] = it["labels"][:n]
            dec[i, :n] = it["dec_input_ids"][:n]
        batch["labels"] = labels
        batch["dec_input_ids"] = dec
        batch["audio_frames"] = np.asarray([it["audio_frames"] for it in items], np.int32)
        return batch
