"""Runtime datasets + collator: dataset rows -> model-ready batches.

Port of ``AmiVideoDataset``, ``WhisperVideoCollator``, ``AVHubertDataset``
and ``make_bucketed_loader`` from ``avsl_tpu/data/runtime.py``. Per item:
the audio resampled to 16 kHz on the host CPU (``kernels/resample.py``),
``pad_or_trim`` to the configured length, log-mel on the host CPU, jiwer-style text
normalisation, the Whisper SOT sequence + tokens with shifted labels +
EOT, and with ``load_video`` the lip clip (88 crop, mean 0.421, std 0.165)
trimmed to the padded audio's length at 25 fps, or one zero frame when the
row has no clip file. SpecAugment runs on the device inside the train step
(``kernels/specaugment.py``). ``AVHubertDataset`` gives each item the
104-dim stacked log-fbank features (computed on the host CPU) and the
88-crop lip clip, truncated to the shorter, with per-item modality drops.
``make_bucketed_loader`` batches by a token budget
(``data/batching.py``), each batch's video padded to its bucket's frames.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np

from avsl_tpu_torch.data.audio_segments import add_noise, load_wav, pcm_to_float
from avsl_tpu_torch.data.batching import LengthBucketBatcher
from avsl_tpu_torch.data.tokenizer import Tokenizer
from avsl_tpu_torch.decode.text_norm import normalize_text
from avsl_tpu_torch.utils.spans import span


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
        from avsl_tpu_torch.kernels.resample import resample_poly

        data = resample_poly(data, sr, target_sr).numpy()
    return data.astype(np.float32)


def _extract_video_path(item: Dict[str, Any], key: str = "lip_video") -> Optional[str]:
    """The clip path of a row's ``lip_video`` cell: a path, a dict with a
    "path", or an object holding one."""
    v = item.get(key)
    if v is None:
        return None
    if isinstance(v, str):
        return v
    if isinstance(v, dict):
        return v.get("path")
    for attr in ("_hf_encoded", "path", "filename"):
        got = getattr(v, attr, None)
        if isinstance(got, dict) and "path" in got:
            return got["path"]
        if isinstance(got, str):
            return got
    return None


class AmiVideoDataset:
    """Per-item AV examples from a dataset / record list."""

    def __init__(
        self,
        hf_dataset,
        tokenizer: Tokenizer,
        audio_max_length: int = 160000,
        n_mels: int = 80,
        lang: str = "en",
        sample_rate: int = 16000,
        image_crop_size: int = 88,
        image_mean: float = 0.421,
        image_std: float = 0.165,
        fps: int = 25,
        load_video: bool = True,
        train: bool = False,
    ):
        self.ds = hf_dataset
        self.tokenizer = tokenizer
        self.audio_max_length = audio_max_length
        self.n_mels = n_mels
        self.lang = lang
        self.sample_rate = sample_rate
        self.image_crop_size = image_crop_size
        self.image_mean = image_mean
        self.image_std = image_std
        self.fps = fps
        self.load_video = load_video
        self.train = train

    def __len__(self) -> int:
        return len(self.ds)

    def audio_length(self, idx: int) -> int:
        """An item's length in samples from its ``duration`` (for
        bucketing), ``audio_max_length`` when it has none. The duration
        column is read once and cached: reading a row of a dataset on disk
        decodes the whole row (its audio and video bytes). A plain list of
        rows, which has no columns, is read row by row."""
        if not hasattr(self, "_durations"):
            try:
                col = self.ds["duration"]
                self._durations = [None if d is None else float(d) for d in col]
            except (KeyError, TypeError, ValueError):
                self._durations = None
        if self._durations is not None:
            dur = self._durations[idx]
        else:
            dur = self.ds[idx].get("duration")
        if dur is not None:
            return int(float(dur) * self.sample_rate)
        return self.audio_max_length

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        from avsl_tpu_torch.kernels.logmel import log_mel_spectrogram, pad_or_trim

        item = self.ds[idx]
        audio = _extract_audio(item, self.sample_rate)
        audio_frames = len(audio) // (self.sample_rate // 100)
        audio = np.asarray(pad_or_trim(audio, self.audio_max_length), np.float32)
        mel = log_mel_spectrogram(audio, n_mels=self.n_mels, device="cpu").numpy()

        text = normalize_text(str(item.get("transcript", "")))
        toks = self.tokenizer.prepare_example(text, self.lang)
        out: Dict[str, Any] = {
            "input_ids": mel.astype(np.float32),  # [n_mels, T]
            "dec_input_ids": np.asarray(toks["dec_input_ids"], np.int64),
            "labels": np.asarray(toks["labels"], np.int64),
            "audio_frames": audio_frames,
        }
        if self.load_video:
            path = _extract_video_path(item)
            if path and os.path.exists(path):
                from avsl_tpu_torch.data.video_io import load_video_feats, trim_video_to_audio

                feats = load_video_feats(path, train=self.train,
                                         image_crop_size=self.image_crop_size,
                                         image_mean=self.image_mean, image_std=self.image_std)
                # trimmed to the padded audio, as the JAX dataset does
                feats = trim_video_to_audio(feats, len(audio), self.sample_rate, self.fps)
                out["video"] = feats.astype(np.float32)
            else:
                crop = self.image_crop_size
                out["video"] = np.zeros((1, crop, crop, 1), np.float32)
        return out


class WhisperVideoCollator:
    """Pad a list of items to one batch.

    labels are padded with -100 (CE ignore), dec_input_ids with EOT, video
    on the time axis with zeros, with ``video_mask`` [B, T] (True = a real
    frame); ``label_pad_len`` and ``video_pad_len`` may pin the padded
    lengths and ``max_label_len`` caps the labels' (text_max_length /
    n_text_ctx). A ``video_pad_len`` given to a call pins that batch's
    alone, so loaders on several threads may share one collator."""

    def __init__(self, eot_id: int, video_pad_len: Optional[int] = None,
                 label_pad_len: Optional[int] = None, max_label_len: Optional[int] = None):
        self.eot_id = eot_id
        self.video_pad_len = video_pad_len
        self.label_pad_len = label_pad_len
        self.max_label_len = max_label_len

    def __call__(self, items: Sequence[Dict[str, Any]],
                 video_pad_len: Optional[int] = None) -> Dict[str, np.ndarray]:
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
        if "video" in items[0]:
            v_len = (video_pad_len or self.video_pad_len
                     or max(len(it["video"]) for it in items))
            h, w, c = items[0]["video"].shape[1:]
            video = np.zeros((len(items), v_len, h, w, c), np.float32)
            vmask = np.zeros((len(items), v_len), bool)
            for i, it in enumerate(items):
                n = min(len(it["video"]), v_len)
                video[i, :n] = it["video"][:n]
                vmask[i, :n] = True
            batch["video"] = video
            batch["video_mask"] = vmask
        return batch


class AVHubertDataset:
    """Per-item AV-HuBERT features with dataset-level modality dropout.

    In training each item drops its audio with ``audio_drop_prob`` and its
    video with ``video_drop_prob`` (draws from ``default_rng((seed, epoch,
    idx))``, so they change every epoch), keeping at least one stream; a
    row without a lip clip counts as video dropped (and then keeps its
    audio). With ``noise_audio`` the audio is mixed with noise at
    ``noise_snr_db`` with probability ``add_noise_prob`` (same rng). Audio
    is the 104-dim stacked log-fbank path, video the normalised 88-crop lip
    clip; both are truncated to the shorter, and a dropped stream comes
    out as zeros with presence flag 0, so every batch has one shape."""

    def __init__(
        self,
        rows,
        audio_drop_prob: float = 0.0,
        video_drop_prob: float = 0.0,
        train: bool = False,
        sample_rate: int = 16000,
        stack_order: int = 4,
        image_crop_size: int = 88,
        seed: int = 0,
        add_noise_prob: float = 0.0,
        noise_audio: Optional[np.ndarray] = None,
        noise_snr_db: float = 0.0,
    ):
        self.rows = rows
        self.audio_drop_prob = audio_drop_prob
        self.video_drop_prob = video_drop_prob
        self.train = train
        self.sample_rate = sample_rate
        self.stack_order = stack_order
        self.image_crop_size = image_crop_size
        self.seed = seed
        self.add_noise_prob = add_noise_prob
        self.noise_audio = noise_audio
        self.noise_snr_db = noise_snr_db
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        from avsl_tpu_torch.kernels.fbank import avhubert_audio_features

        item = self.rows[idx]
        rng = np.random.default_rng((self.seed, self.epoch, idx))
        drop_audio = self.train and rng.random() < self.audio_drop_prob
        drop_video = self.train and rng.random() < self.video_drop_prob
        if drop_audio and drop_video:  # at-least-one-modality fallback
            if rng.random() < 0.5:
                drop_audio = False
            else:
                drop_video = False
        audio = _extract_audio(item, self.sample_rate)
        if self.train and self.noise_audio is not None and rng.random() < self.add_noise_prob:
            audio = add_noise(audio, self.noise_audio, self.noise_snr_db, rng)
        feats_a = avhubert_audio_features(audio, self.sample_rate, self.stack_order,
                                          device="cpu").numpy()
        path = _extract_video_path(item)
        if path and os.path.exists(path):
            from avsl_tpu_torch.data.video_io import load_video_feats

            feats_v = load_video_feats(path, image_crop_size=self.image_crop_size)
        else:
            crop = self.image_crop_size
            feats_v = np.zeros((len(feats_a), crop, crop, 1), np.float32)
            drop_video = True
            drop_audio = False  # the at-least-one guarantee
        t = min(len(feats_a), len(feats_v))  # truncate-to-min alignment
        out = {
            "audio_feats": np.zeros_like(feats_a[:t]) if drop_audio else feats_a[:t],
            "video_feats": np.zeros_like(feats_v[:t]) if drop_video else feats_v[:t],
            "audio_present": 0.0 if drop_audio else 1.0,
            "video_present": 0.0 if drop_video else 1.0,
        }
        if "transcript" in item:
            out["transcript"] = item["transcript"]
        return out


def make_bucketed_loader(
    dataset: AmiVideoDataset,
    collator: WhisperVideoCollator,
    batch_bins: int,
    num_shards: int = 1,
    shuffle: bool = True,
    epoch: int = 0,
    fps: int = 25,
) -> Iterator[Dict[str, np.ndarray]]:
    """Collated batches by token budget: item lengths in 100 Hz audio
    frames (``max(audio_length // 160, 1)``) drive ``LengthBucketBatcher``,
    and each batch's video is padded to its bucket's frame count,
    ``ceil(padded * fps / 100)``, given to ``collator`` with the batch (it
    writes nothing on the shared collator, which a validation on another
    thread may be using)."""
    if hasattr(dataset, "set_epoch"):
        dataset.set_epoch(epoch)  # re-draw per-epoch augmentation
    lengths = [max(dataset.audio_length(i) // 160, 1) for i in range(len(dataset))]
    batcher = LengthBucketBatcher(lengths, batch_bins, num_shards=num_shards)
    for idx, padded_frames in batcher.batches(shuffle=shuffle, epoch=epoch):
        with span("data.batch"):
            items = [dataset[int(i)] for i in idx]
            batch = collator(items,
                             video_pad_len=max(int(np.ceil(padded_frames * fps / 100.0)), 1))
        yield batch
