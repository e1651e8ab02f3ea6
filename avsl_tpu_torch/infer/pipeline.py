"""Batch transcription with host/device overlap (greedy or beam search,
audio and lip video).

Port of ``StreamingTranscriber`` and ``TranscribeResult`` from
``avsl_tpu/infer/pipeline.py``. Per batch: log-mel -> Whisper encoder
(the flash-attention kernel in every block) and, for a Whisper-Flamingo
model, the lip clips -> the AV-HuBERT video tower (the same kernel in
every block) -> ``video_projection``; then the decode cache with the
cross-attention and gated ``x_attn`` K/V precomputed -> KV-cached greedy
decode with the mean token log-probability, or with ``beam_size > 1`` the
batched beam search with its length-normalised score. On a card, without
a mesh or phrase boosting, the greedy decode's self caches take an index
on the device and its steps replay one CUDA graph a batch
(``decode/greedy.py``). The model runs in
eval mode whatever mode the caller left it in (the JAX transcriber always
serves deterministically), and gets its mode back afterwards.
``transcribe`` prepares batch N+1 on a producer thread while the device
runs batch N; ``transcribe_long`` splits items of any length into windows
(``infer/longform.py``).

The serving options of the JAX transcriber: ``boost_phrases`` (a biasing
trie in every decode, ``decode/biasing.py``); ``temperature_fallback``,
which re-decodes the whole batch by temperature sampling while an item's
mean log-probability is below ``logprob_threshold`` or its text
compresses above ``compression_ratio_threshold``, adopting a retry per
item when it passes (at the last temperature also when it scores
better); and ``word_timestamps``, one teacher-forced alignment forward a
batch (``decode/word_timestamps.py``). The retries and the alignment pass
reuse the batch's encoder outputs (the JAX program re-encodes; the
encoder is deterministic, so the features are the same). The k-th retry
of the n-th fallback batch seeds its generator with ``1234 + 31 n + k``
where JAX folds ``31 n + k`` into ``PRNGKey(1234)``: the draws differ
from JAX's bits, not in law.

An item's video is its ``lip_feats`` array, else its ``lip_video`` clip
(a corrupt clip falls through), else its raw ``video`` closeup, decoded to
grayscale at ``raw_video_hw`` and lip-cropped: with
``raw_lip_mode="host_refined"`` (default) on the producer thread by the
preprocessing's own ``RefinedMouthTracker`` and ``extract_lip_clip`` (the
warp on the model's device), with ``"device"`` (or when the refined
tracker finds nothing) by the staged lip frontend on the device
(``kernels/lip_pipeline.py``). Decoding a clip and the refined tracker
need OpenCV on the host. Items without video get a zeroed clip and
``has_video=False``, so audio-only and audio-visual items share a batch.

The options that change the decode's cost: ``quantize="int8"`` serves a
copy of the model whose weights are int8 with per-channel scales,
dequantized to bf16 at each use (``models/quant.py``; from ``weights``,
the fp32 state dict the model was loaded from, when given; the caller's
model is left as it was); ``kv_int8`` compresses the decode cache's
cross-attention and "xv" K/V to int8 rows; ``draft_model`` (an audio-only
Whisper with its weights, or ``draft_variables``, a state dict loaded into
it) proposes ``spec_k`` tokens a round of speculative greedy decoding
(``decode/speculative.py``), token-exact against greedy, on its own
log-mel at its own ``n_mels``; ``spec_stats()`` reports its acceptance.

``mesh`` (a ``core/mesh.py::Mesh``; one process a rank) serves on a
(data, model) mesh, as ``avsl_tpu/infer/pipeline.py:134-190`` does: the
weights go through ``core/partitioning.py::shard_state`` (tensor
parallelism over the model axis), every rank prepares the same batch and
computes the rows of its data rank, and the results are gathered over the
data axis in item order, so every rank returns every item's result. The
draft stays whole on every rank. ``quantize`` with a mesh, and a
``batch_size`` the data axis does not divide, are refused. The sampled
fallback draws its noise at the whole batch's shape
(``core/mesh.py::draw_rows``), so a row gets the draws one device gives
it. :meth:`StreamingTranscriber.follow` and
:meth:`StreamingTranscriber.lead` let one rank take requests (the
daemon) while the others run each of its batches.
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass
from queue import Queue
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from avsl_tpu_torch.core.mesh import RowShard, row_shard_scope
from avsl_tpu_torch.data.audio_segments import load_wav
from avsl_tpu_torch.data.video_io import load_video_feats, read_video_frames
from avsl_tpu_torch.decode.beam import beam_search
from avsl_tpu_torch.decode.biasing import build_biasing_trie, encode_phrases
from avsl_tpu_torch.decode.greedy import StepGraphs, greedy_decode_scored, sampled_decode_scored
from avsl_tpu_torch.decode.speculative import speculative_greedy_decode
from avsl_tpu_torch.decode.text_norm import compression_ratio
from avsl_tpu_torch.decode.word_timestamps import align_words
from avsl_tpu_torch.infer.longform import LongFormResult, split_item, stitch
from avsl_tpu_torch.kernels.lip_pipeline import make_staged_lip_frontend
from avsl_tpu_torch.kernels.logmel import log_mel_spectrogram, pad_or_trim
from avsl_tpu_torch.models.quant import quantize_kv_cache, quantize_model
from avsl_tpu_torch.utils.spans import count, span


@dataclass
class TranscribeResult:
    id: str
    text: str
    tokens: List[int]
    has_video: bool
    # mean token log-probability of the generated sequence (greedy), or
    # the length-normalised log-probability of the best beam
    avg_logprob: float = 0.0
    # word timestamps (cross-attention DTW) with word_timestamps=True:
    # [{"word", "start_s", "end_s"}]
    words: Optional[List[dict]] = None


class PreparedBatch(NamedTuple):
    """One host-prepared batch: audio [B, samples] float32, video [B,
    frames, crop, crop, 1] float32 (zeros where an item has none or a raw
    closeup), raw [B, frames, H, W] uint8 closeups to lip-crop on the
    device (None when the batch has none), raw_mask [B] bool, raw_frames
    [B] int32 decoded frames a closeup, has_video per item, and each row's
    audio samples before padding (for the word timestamps' frames)."""

    audio: np.ndarray
    video: np.ndarray
    raw: Optional[np.ndarray]
    raw_mask: np.ndarray
    raw_frames: np.ndarray
    flags: List[bool]
    n_samples: Optional[np.ndarray] = None


class BatchOutput(NamedTuple):
    """The device half's result for one batch: tokens [B, max_new_tokens],
    scores [B], and per row its words (None without word timestamps)."""

    tokens: np.ndarray
    scores: np.ndarray
    words: Optional[List[List[dict]]] = None


class StreamingTranscriber:
    """Greedy or beam-search batch transcription with host/device overlap.

    ``model`` is a :class:`~avsl_tpu_torch.models.Whisper` already on its
    device; batches run there. Audio is padded or trimmed to
    ``audio_max_length`` samples and video to ``video_frames`` frames of
    ``crop`` x ``crop``; a batch always holds ``batch_size`` rows. The
    serving options are described in the module docstring.
    """

    def __init__(
        self,
        model,
        tokenizer,
        audio_max_length: int = 160000,
        video_frames: int = 250,
        crop: int = 88,
        batch_size: int = 8,
        max_new_tokens: int = 64,
        beam_size: int = 1,
        lang: str = "en",
        prefetch: int = 2,
        raw_video_hw: Tuple[int, int] = (288, 352),
        raw_lip_mode: str = "host_refined",
        quantize: Optional[str] = None,
        kv_int8: bool = False,
        mesh: Optional[Any] = None,
        temperature_fallback: Sequence[float] = (),
        logprob_threshold: float = -1.0,
        compression_ratio_threshold: float = 2.4,
        word_timestamps: bool = False,
        draft_model: Optional[Any] = None,
        draft_variables: Optional[Mapping[str, torch.Tensor]] = None,
        spec_k: int = 4,
        boost_phrases: Optional[Sequence[str]] = None,
        boost_weight: float = 4.0,
        weights: Optional[Mapping[str, torch.Tensor]] = None,
    ):
        self.mesh = mesh
        self._leading = False
        rows = batch_size
        if mesh is not None:
            if quantize is not None:
                raise ValueError(
                    "quantize + mesh unsupported: int8 halves one card's weight traffic, tensor "
                    "parallelism splits it across cards — pick one")
            n_data = mesh.shape["data"]
            if batch_size % n_data:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by the mesh data axis ({n_data})")
            rows = batch_size // n_data
            from avsl_tpu_torch.core.partitioning import shard_state
            from avsl_tpu_torch.train.loop import TrainState

            shard_state(TrainState(model=model, optimizer=None), mesh)
        if raw_lip_mode not in ("host_refined", "device"):
            raise ValueError(f"raw_lip_mode {raw_lip_mode!r}")
        self.temperature_fallback = tuple(float(t) for t in temperature_fallback)
        self.logprob_threshold = float(logprob_threshold)
        self.compression_ratio_threshold = float(compression_ratio_threshold)
        if self.temperature_fallback and beam_size > 1:
            raise ValueError("temperature_fallback composes with greedy decode only "
                             "(the beam already explores alternatives)")
        self._fallback_calls = 0  # batches the fallback has examined
        self.fallback_decodes = 0  # sampled re-decodes run
        # speculative telemetry, filled when a draft runs
        self._spec_batches = 0
        self._spec_accept_sum = 0.0
        self._spec_rounds_sum = 0
        if draft_model is None and draft_variables is not None or (
                draft_model is not None and draft_model.device.type == "meta"):
            raise ValueError("draft_model and draft_variables go together")
        if draft_model is not None and beam_size > 1:
            raise ValueError("speculative decoding composes with greedy only")
        self.spec_k = int(spec_k)
        if draft_model is not None and self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if draft_variables is not None:
            draft_model.load_state_dict(draft_variables)
        self.draft_model = draft_model
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize {quantize!r} (expected None or 'int8')")
        self.quantize = quantize
        if quantize == "int8":
            model = quantize_model(model, weights)
        self.kv_int8 = bool(kv_int8)
        self.word_timestamps = bool(word_timestamps)
        self._step_graphs = StepGraphs()
        self.model = model
        self.tokenizer = tokenizer
        self.device = model.device
        self.audio_max_length = audio_max_length
        self.video_frames = video_frames
        self.crop = crop
        self.batch_size = batch_size
        self.max_new_tokens = max_new_tokens
        self.beam_size = beam_size
        self.lang = lang
        self.prefetch = prefetch
        self.raw_video_hw = raw_video_hw
        self.raw_lip_mode = raw_lip_mode
        self._lip_stages = make_staged_lip_frontend(video_frames)
        sot = np.asarray(tokenizer.sot_sequence(lang), np.int64)
        # the prompt of the rows this rank computes (all of them off a mesh)
        self._prompt_np = np.tile(sot[None], (rows, 1))
        self._prompt = torch.as_tensor(self._prompt_np, device=self.device)
        self.boost_phrases = tuple(boost_phrases or ())
        self._biasing = None
        if self.boost_phrases:
            if draft_model is not None:
                raise ValueError(
                    "boost_phrases does not compose with speculative decoding (the "
                    "draft-verify loop is token-exact vs unbiased greedy) — drop "
                    "draft_model or the boost")
            self._biasing = build_biasing_trie(
                encode_phrases(tokenizer, self.boost_phrases), model.cfg.n_vocab,
                weight=float(boost_weight), device=self.device)

    def _lip_from_raw(self, clips_u8: torch.Tensor, n_frames: torch.Tensor) -> torch.Tensor:
        """Raw closeups [B, frames, H, W] uint8 on the device -> normalised
        lip frames [B, frames, crop, crop, 1]: the staged frontend (detection
        stream, trajectory, closed-form coordinates, separable sampling),
        the centre ``crop`` of the 96 x 96 crops, ``(x / 255 - 0.421) /
        0.165``, and zeros past each clip's ``n_frames`` (as the lip-clip
        path pads)."""
        st = self._lip_stages
        traj, face_w, _ok = st["traj"](st["subsample"](clips_u8))
        lip96 = st["sample"](clips_u8, *st["coords_from_traj"](traj, face_w))
        off = (96 - self.crop) // 2
        lip = lip96[:, :, off: off + self.crop, off: off + self.crop, None]
        lip = (lip / 255.0 - 0.421) / 0.165
        t_idx = torch.arange(lip.shape[1], device=lip.device)[None, :, None, None, None]
        return torch.where(t_idx < n_frames[:, None, None, None, None], lip, 0.0)

    @torch.inference_mode()
    def run_batch(self, batch: PreparedBatch) -> BatchOutput:
        """The device half of one prepared batch: its raw closeups
        lip-cropped on the device and merged into its video, then
        :meth:`_run`. On a mesh this rank computes its data rank's rows
        and the outputs of every row are gathered; while :meth:`lead`
        is on, the batch goes to the other ranks first."""
        if self._leading:
            _broadcast(batch)
        if self.mesh is None:
            return self._run_rows(batch)
        return self._gather_rows(self._run_rows(self._own_rows(batch)))

    def _own_rows(self, batch: PreparedBatch) -> PreparedBatch:
        """This data rank's contiguous rows of a prepared batch."""
        n, r = self.mesh.shape["data"], self.mesh.data_rank
        size = self.batch_size // n
        cut = slice(r * size, (r + 1) * size)
        return PreparedBatch(batch.audio[cut], batch.video[cut],
                             None if batch.raw is None else batch.raw[cut],
                             batch.raw_mask[cut], batch.raw_frames[cut], batch.flags[cut],
                             None if batch.n_samples is None else batch.n_samples[cut])

    def _gather_rows(self, out: BatchOutput) -> BatchOutput:
        """Every data rank's rows of a batch's outputs, in row order."""
        import torch.distributed as dist

        n, group = self.mesh.shape["data"], self.mesh.data_group
        if n == 1:
            return out
        parts = []
        for a in (out.tokens, out.scores):
            t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            got = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(got, t, group=group)
            parts.append(torch.cat(got).cpu().numpy())
        words = None
        if out.words is not None:
            got = [None] * n
            dist.all_gather_object(got, out.words, group=group)
            words = [w for part in got for w in part]
        return BatchOutput(parts[0], parts[1], words)

    def lead(self, on: bool = True) -> None:
        """On the rank that takes requests (rank 0): from now on send each
        batch to the other ranks before running it (``on``), or tell them
        to stop (``on=False``); they wait in :meth:`follow`."""
        if not on and self._leading:
            _broadcast(None)
        self._leading = on

    def follow(self) -> int:
        """On every other rank: run the batches of the rank that leads,
        until it stops. Returns the number of batches run."""
        n = 0
        while True:
            batch = _broadcast(None)
            if batch is None:
                return n
            self.run_batch(batch)
            n += 1

    def _run_rows(self, batch: PreparedBatch) -> BatchOutput:
        """The device half of the rows this rank computes."""
        video = batch.video
        if batch.raw is not None and self.model.cfg.add_gated_x_attn:
            with span("serve.upload"):
                raw, raw_frames, raw_mask, video = (
                    self._upload(a) for a in (batch.raw, batch.raw_frames, batch.raw_mask, video))
            lip = self._lip_from_raw(raw, raw_frames)
            video = torch.where(raw_mask[:, None, None, None, None], lip, video)
        return self._run(batch.audio, video, batch.n_samples)

    def _upload(self, a: np.ndarray, non_blocking: bool = False) -> torch.Tensor:
        """A host array on the model's device, its bytes counted as
        ``h2d_bytes``."""
        count("h2d_bytes", a.nbytes)
        return torch.from_numpy(a).to(self.device, non_blocking=non_blocking)

    @torch.inference_mode()
    def _run(self, audio: np.ndarray, video, n_samples: Optional[np.ndarray] = None
             ) -> BatchOutput:
        """Device program for one padded batch: audio [B, samples] and
        video [B, frames, crop, crop, 1] float32 (an array or a tensor on
        the device) -> tokens, scores and, with word timestamps, the words
        of each row (``n_samples`` [B] its audio before padding; the whole
        window when None), in eval mode (the caller's mode is restored
        after). A model without gated cross-attention ignores the video, so
        it is not uploaded."""
        with self.serving_mode():
            with span("serve.upload"):
                x = self._upload(audio, non_blocking=True)
            with span("serve.encode"):
                feats, xv = self.encode(x, video)
                dfeats = None if self.draft_model is None else self.encode_draft(x)
            out = self._decode(feats, xv, dfeats=dfeats)
            if dfeats is not None:
                self._spec_batches += 1
                self._spec_accept_sum += float(out.accept_rate)
                self._spec_rounds_sum += int(out.rounds)
            with span("serve.readback"):
                seqs, scores = out[0].cpu().numpy(), out[1].cpu().numpy()
            if self.temperature_fallback:
                seqs, scores = self._fallback(feats, xv, seqs, scores)
            words = None
            if self.word_timestamps:
                if n_samples is None:
                    n_samples = np.full((audio.shape[0],), audio.shape[1])
                tokens = np.concatenate([self._prompt_np, seqs.astype(np.int64)], axis=1)
                frames = [max(int(np.ceil(n / 320.0)), 1) for n in n_samples]
                words = align_words(self.model, feats, xv, tokens, self.tokenizer, frames, 50.0)
        return BatchOutput(seqs, scores, words)

    @contextlib.contextmanager
    def serving_mode(self):
        """The model and the draft in eval mode within the block, each in
        the mode the caller left it in afterwards."""
        models = [m for m in (self.model, self.draft_model) if m is not None]
        modes = [m.training for m in models]
        for m in models:
            m.eval()
        try:
            yield
        finally:
            for m, mode in zip(models, modes):
                m.train(mode)

    def encode(self, audio: torch.Tensor, video) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Log-mel and the model's encoders for a batch of audio [B,
        samples] on the device (and video, which only a model with gated
        cross-attention reads): ``(audio features, projected video or
        None)``."""
        cfg = self.model.cfg
        v = None
        if cfg.add_gated_x_attn:
            if isinstance(video, torch.Tensor):
                v = video.to(self.device, non_blocking=True)
            else:
                with span("serve.upload"):
                    v = self._upload(np.asarray(video), non_blocking=True)
        return self.model.encode(log_mel_spectrogram(audio, n_mels=cfg.n_mels), v)

    def encode_draft(self, audio: torch.Tensor) -> torch.Tensor:
        """The draft model's audio features: its own log-mel at its own
        ``n_mels`` through its encoder (a draft is audio-only)."""
        draft = self.draft_model
        return draft.encode(log_mel_spectrogram(audio, n_mels=draft.cfg.n_mels))[0]

    def cache_len(self, sampled: bool = False) -> int:
        """Positions of a decode cache: the prompt and the new tokens, plus
        ``spec_k + 1`` for speculative decoding's verify pass, else 2."""
        extra = self.spec_k + 1 if self.draft_model is not None and not sampled else 2
        return self.max_new_tokens + self._prompt.shape[1] + extra

    def decode_cache(self, feats, xv, max_len: int, device_index: bool = False):
        """The model's decode cache, int8-compressed with ``kv_int8``; with
        ``device_index`` every block's self cache shares one 0-dim int64
        index on the device instead of a host integer."""
        cache = self.model.init_decode_cache(feats, xv, max_len)
        if device_index:
            index = torch.zeros((), dtype=torch.int64, device=feats.device)
            for entry in cache:
                entry["self"]["index"] = index
        return quantize_kv_cache(cache) if self.kv_int8 else cache

    def graphs_decode(self) -> bool:
        """Whether the greedy decode may replay its steps as a CUDA graph:
        on a card, with no mesh (no process group joins a step) and no
        phrase boosting."""
        return self.device.type == "cuda" and self.mesh is None and self._biasing is None

    def _decode(self, feats, xv, temperature: Optional[float] = None,
                generator: Optional[torch.Generator] = None, dfeats=None):
        """One decode of a batch's encoder outputs on a fresh cache: beam
        search, greedy, speculative greedy against the draft's features
        ``dfeats`` (a :class:`SpecDecodeResult`), or with ``temperature``
        sampled from ``generator``. -> (tokens [B, max_new_tokens], scores
        [B], ...) on the device."""
        model = self.model
        sampled = temperature is not None
        graphs = None
        if not sampled and dfeats is None and self.beam_size == 1 and self.graphs_decode():
            graphs = self._step_graphs
        with span("serve.cache"):
            cache = self.decode_cache(feats, xv, self.cache_len(sampled),
                                      device_index=graphs is not None)

        def step(tok, c):
            return model.decode(tok, None, None, c)

        args = (step, cache, self._prompt)
        eot = self.tokenizer.eot
        if dfeats is not None and not sampled:
            draft = self.draft_model
            return speculative_greedy_decode(
                step, lambda tok, c: draft.decode(tok, None, None, c), cache,
                draft.init_decode_cache(dfeats, None, self.cache_len()), self._prompt,
                self.max_new_tokens, eot, k=self.spec_k)
        if self.beam_size > 1:
            return beam_search(*args, self.beam_size, self.max_new_tokens, eot,
                               biasing=self._biasing)
        if temperature is None:
            return greedy_decode_scored(*args, self.max_new_tokens, eot, biasing=self._biasing,
                                        graphs=graphs)
        return sampled_decode_scored(*args, self.max_new_tokens, eot, temperature, generator,
                                     biasing=self._biasing)

    def spec_stats(self) -> Optional[Dict[str, float]]:
        """Draft-quality telemetry: mean acceptance rate and verify rounds
        a batch since start; None before any speculative batch."""
        if not self._spec_batches:
            return None
        return {"batches": self._spec_batches,
                "mean_accept_rate": self._spec_accept_sum / self._spec_batches,
                "mean_verify_rounds": self._spec_rounds_sum / self._spec_batches}

    def _row_shard(self) -> Optional[RowShard]:
        """The data rank's share of a batch's rows, for the sampled draws."""
        if self.mesh is None:
            return None
        return RowShard(self.mesh.data_group, self.mesh.data_rank, self.mesh.shape["data"])

    def _retry_mask(self, seqs: np.ndarray, scores: np.ndarray) -> np.ndarray:
        """Per row: confidence below ``logprob_threshold``, or text that
        compresses above ``compression_ratio_threshold`` (repetition)."""
        special = self.tokenizer.special_token_set
        need = scores < self.logprob_threshold
        for i in range(seqs.shape[0]):
            if need[i]:
                continue
            text = self.tokenizer.decode([int(x) for x in seqs[i] if int(x) not in special])
            if compression_ratio(text) > self.compression_ratio_threshold:
                need[i] = True
        return need

    def _fallback(self, feats, xv, seqs: np.ndarray, scores: np.ndarray):
        """The temperature fallback over a batch's greedy result: re-decode
        the whole batch at each temperature while a row fails the gate,
        adopting a retry per row when it passes, or, at the last
        temperature, when it scores better than what the row has."""
        need = self._retry_mask(seqs, scores)
        self._fallback_calls += 1
        last = len(self.temperature_fallback) - 1
        for k, temp in enumerate(self.temperature_fallback):
            if not need.any():
                break
            gen = torch.Generator(device=self.device)
            gen.manual_seed(1234 + self._fallback_calls * 31 + k)
            with row_shard_scope(self._row_shard()):
                s2, sc2 = (t.cpu().numpy() for t in self._decode(feats, xv, temp, gen)[:2])
            self.fallback_decodes += 1
            passes = ~self._retry_mask(s2, sc2)
            adopt = need & (passes | ((k == last) & (sc2 > scores)))
            seqs = np.where(adopt[:, None], s2, seqs)
            scores = np.where(adopt, sc2, scores)
            need = need & ~(adopt & passes)
        return seqs, scores

    # -- host side -----------------------------------------------------

    def _load_item(self, item: Dict[str, Any]):
        """-> (audio, video [frames, crop, crop, 1] or None, raw closeup
        [frames, H, W] uint8 or None, decoded raw frames, has_video, audio
        samples before padding).

        ``lip_feats``: precomputed normalised lip features [T, crop, crop,
        1]. ``lip_video``: an already-extracted lip clip file, decoded and
        normalised here; a clip that fails to load falls through. ``video``:
        a raw closeup, decoded to grayscale; ``host_refined`` lip-crops it
        here, ``device`` (and a closeup the refined tracker finds nothing
        in) resizes it to ``raw_video_hw`` for the device frontend. A
        closeup that fails to decode leaves the item audio-only."""
        audio = load_wav(item["audio"]) if isinstance(item["audio"], str) else item["audio"]
        n_samples = min(len(audio), self.audio_max_length)
        audio = pad_or_trim(np.asarray(audio, np.float32), self.audio_max_length)

        feats = None
        lf = item.get("lip_feats")
        if lf is not None:
            feats = np.asarray(lf, np.float32)[: self.video_frames]
        lip = item.get("lip_video")
        if feats is None and lip and isinstance(lip, str) and os.path.exists(lip):
            try:
                feats = load_video_feats(lip, image_crop_size=self.crop,
                                         max_frames=self.video_frames)
            except Exception:  # a corrupt lip clip falls through, as in the JAX transcriber
                feats = None
        raw = item.get("video")
        if feats is None and raw and isinstance(raw, str) and os.path.exists(raw):
            try:
                frames = read_video_frames(raw, grayscale=True, max_frames=self.video_frames)
                if self.raw_lip_mode == "host_refined":
                    feats = self._host_refined_lip(frames)
                if feats is None:
                    h, w = self.raw_video_hw
                    if frames.shape[1:] != (h, w):
                        import cv2

                        frames = np.stack([cv2.resize(f, (w, h)) for f in frames])
                    clip = np.zeros((self.video_frames, h, w), np.uint8)
                    clip[: len(frames)] = frames.astype(np.uint8)
                    return audio, None, clip, len(frames), True, n_samples
            except Exception:  # an undecodable closeup leaves the item audio-only, as in JAX
                feats = None
        if feats is not None:
            video = np.zeros((self.video_frames, self.crop, self.crop, 1), np.float32)
            video[: len(feats)] = feats
            return audio, video, None, 0, True, n_samples
        return audio, None, None, 0, False, n_samples

    def _host_refined_lip(self, frames: np.ndarray) -> Optional[np.ndarray]:
        """The offline preprocessing's lip crop at serving time
        (``RefinedMouthTracker`` then ``extract_lip_clip``, the warp on the
        model's device), then the lip-clip loader's centre crop and
        normalisation; None when the tracker finds no landmarks."""
        from avsl_tpu_torch.data.lip_refine import RefinedMouthTracker
        from avsl_tpu_torch.data.lip_roi import extract_lip_clip

        if not hasattr(self, "_host_detector"):
            self._host_detector = RefinedMouthTracker()
        clip = extract_lip_clip(frames, self._host_detector(frames), device=self.device)
        if clip is None:
            return None
        clip = clip[: self.video_frames]
        off = (96 - self.crop) // 2
        lip = clip[:, off: off + self.crop, off: off + self.crop, None]
        return (lip.astype(np.float32) / 255.0 - 0.421) / 0.165

    def _prepare_batch(self, items: Sequence[Dict[str, Any]]) -> PreparedBatch:
        """Load a batch's items on the host into a :class:`PreparedBatch`
        of ``batch_size`` rows."""
        audio = np.zeros((self.batch_size, self.audio_max_length), np.float32)
        video = np.zeros((self.batch_size, self.video_frames, self.crop, self.crop, 1),
                         np.float32)
        h, w = self.raw_video_hw
        raw = None
        raw_mask = np.zeros((self.batch_size,), bool)
        raw_frames = np.zeros((self.batch_size,), np.int32)
        n_samples = np.zeros((self.batch_size,), np.int64)
        flags: List[bool] = []
        for i, item in enumerate(items):
            audio[i], v, clip, n_frames, has_video, n_samples[i] = self._load_item(item)
            if v is not None:
                video[i] = v
            if clip is not None:
                if raw is None:
                    raw = np.zeros((self.batch_size, self.video_frames, h, w), np.uint8)
                raw[i] = clip
                raw_mask[i] = True
                raw_frames[i] = n_frames
            flags.append(has_video)
        return PreparedBatch(audio, video, raw, raw_mask, raw_frames, flags, n_samples)

    def _results(self, chunk, flags, out: BatchOutput, first_index: int) -> List[TranscribeResult]:
        special = self.tokenizer.special_token_set
        results = []
        for i in range(len(chunk)):
            toks = [int(x) for x in out.tokens[i]]
            text_ids = [x for x in toks if x not in special]
            results.append(
                TranscribeResult(
                    id=str(chunk[i].get("id", first_index + i)),
                    text=self.tokenizer.decode(text_ids).strip(),
                    tokens=toks,
                    has_video=flags[i],
                    avg_logprob=round(float(out.scores[i]), 4),
                    words=None if out.words is None else out.words[i],
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
        batch = self._prepare_batch(chunk)
        return self._results(chunk, batch.flags, self.run_batch(batch), 0)

    def transcribe_long(self, items: Sequence[Dict[str, Any]]) -> List[LongFormResult]:
        """Items of any duration (audio path or array, optionally a
        ``lip_video`` clip): each split at minimum-energy points into
        windows of at most ``audio_max_length`` samples
        (``infer/longform.py``), every item's windows served together
        through :meth:`transcribe`, then stitched back per item."""
        window_items: List[Dict[str, Any]] = []
        bounds: List[int] = [0]
        spans: List[List] = []
        for item in items:
            w, sp = split_item(item, self.audio_max_length, self.video_frames, crop=self.crop)
            window_items.extend(w)
            bounds.append(len(window_items))
            spans.append(sp)
        flat = self.transcribe(window_items)
        return [stitch(str(item.get("id", j)), flat[bounds[j]: bounds[j + 1]], spans[j])
                for j, item in enumerate(items)]

    def transcribe(self, items: Sequence[Dict[str, Any]]) -> List[TranscribeResult]:
        """Items: dicts with 'id', 'audio' (path or array) and optionally
        'lip_feats' (array), 'lip_video' (path) or 'video' (a raw closeup's
        path). Returns per-item results in order; host loading of the next
        batch overlaps the device work of the current one."""
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
                    with span("serve.prepare"):
                        prepared = self._prepare_batch(chunk)
                    queue.put((chunk, prepared))
                queue.put(None)
            except Exception as e:  # re-raised by the consumer
                queue.put(("__producer_error__", e))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        results: List[TranscribeResult] = []
        while True:
            with span("serve.queue_wait"):
                got = queue.get()
            if got is None:
                break
            if got[0] == "__producer_error__":
                t.join()
                raise got[1]
            chunk, batch = got
            with span("serve.batch"):
                out = self.run_batch(batch)
            with span("serve.results"):
                results.extend(self._results(chunk, batch.flags, out, len(results)))
        t.join()
        return results


def _broadcast(obj):
    """``obj`` from rank 0 to every rank of the default process group."""
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
