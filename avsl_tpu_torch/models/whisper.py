"""Whisper encoder/decoder in PyTorch, with Whisper-Flamingo video fusion.

Port of ``WhisperEncoder``, ``WhisperTextDecoder`` and the ``Whisper``
methods ``encode``, ``encode_towers``, ``project_and_decode``, ``decode``,
``init_decode_cache`` and ``__call__`` from ``avsl_tpu/models/whisper.py``,
with the OpenAI state-dict names. With ``cfg.add_gated_x_attn`` every
decoder block carries the tanh-gated ``x_attn``/``x_mlp`` sublayers on the
projected video stream ``xv`` (``video_projection`` of the ``video_model``
features, the AV-HuBERT video tower in the flagship config). Linear,
convolution and embedding weights live in ``cfg.param_dtype`` and are cast
to the compute dtype ``cfg.dtype`` at use when the two differ (training:
fp32 weights, bf16 compute); layer norms and the gates are fp32. In
training mode (``model.train()``) each block applies residual dropout at
``cfg.dropout_rate`` with masks drawn from the ``generator`` the forward
is given, and the video tower trains too: its dropouts, LayerDrop and,
unless ``freeze_video_bn_stats``, BatchNorm on the batch's statistics,
which update the running ones.

Models are built on the ``meta`` device and materialised with
:meth:`Whisper.materialize`, which allocates on the target device and
fills the weights from an explicit ``torch.Generator`` there, so the
large model never passes through the CPU.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from avsl_tpu_torch.core.config import WhisperConfig
from avsl_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    constrain_activation,
    copy_to_group,
    gather_from_group,
    reduce_from_group,
)
from avsl_tpu_torch.models.layers import (
    Cache,
    CastConv1d,
    CastLinear,
    LayerNormF32,
    TransformerBlock,
    cast_param,
    check_remat_policy,
    init_self_attn_cache,
    positions,
    remat_block,
    sinusoid_embedding,
    torch_dtype,
)


def _dtypes(cfg: WhisperConfig) -> Tuple[torch.dtype, torch.dtype]:
    """(compute dtype, parameter dtype) of ``cfg``."""
    return torch_dtype(cfg.dtype), torch_dtype(cfg.param_dtype)


class WhisperEncoder(nn.Module):
    """Audio encoder: mel [B, n_mels, T] -> features [B, T//2, n_audio_state].
    With ``cfg.remat`` each block runs under :func:`remat_block` with
    ``cfg.remat_policy`` (``whisper.py:70-74``; the text decoder is not
    rematerialised, as in JAX)."""

    def __init__(self, cfg: WhisperConfig, device=None):
        super().__init__()
        self.remat = bool(cfg.remat)
        self.remat_policy = check_remat_policy(cfg.remat_policy)
        dtype, pdtype = _dtypes(cfg)
        d = cfg.n_audio_state
        kw = dict(device=device, param_dtype=pdtype, compute_dtype=dtype)
        self.conv1 = CastConv1d(cfg.n_mels, d, 3, padding=1, **kw)
        self.conv2 = CastConv1d(d, d, 3, stride=2, padding=1, **kw)
        self.register_buffer(
            "positional_embedding", torch.empty((cfg.n_audio_ctx, d), device=device, dtype=dtype)
        )
        self.blocks = nn.ModuleList(
            TransformerBlock(d, cfg.n_audio_head, 4 * d, dtype=dtype, device=device,
                             param_dtype=pdtype, dropout=cfg.dropout_rate)
            for _ in range(cfg.n_audio_layer)
        )
        self.ln_post = LayerNormF32(d, device=device)

    def reset_positional_embedding(self) -> None:
        table = sinusoid_embedding(*self.positional_embedding.shape)
        with torch.no_grad():
            self.positional_embedding.copy_(torch.from_numpy(table))

    def forward(
        self, mel: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        x = F.gelu(self.conv1(mel.to(self.conv1.compute_dtype)))
        x = F.gelu(self.conv2(x)).transpose(1, 2)  # [B, T, d]
        x = x + self.positional_embedding[: x.shape[1]]
        # sequence parallelism between blocks (None outside
        # core/mesh.py::activation_sharding_scope, or when the model axis
        # does not divide T)
        x, split = constrain_activation(x, DATA_AXIS, MODEL_AXIS, None)
        for block in self.blocks:
            if self.remat:
                x, _ = remat_block(block, self.remat_policy, (generator,), x, generator=generator,
                                   seq_split=split)
            else:
                x, _ = block(x, generator=generator, seq_split=split)
        if split is not None:
            x = split.gather(x)
        return self.ln_post(x)


class WhisperTextDecoder(nn.Module):
    """Text decoder with learned positions, logits tied to the token
    embedding (fp32 logits) and, with ``cfg.add_gated_x_attn``, the gated
    video cross-attention in every block.

    With a vocab-sharded embedding (:meth:`set_vocab_parallel`) each model
    rank holds its rows of the vocabulary: the lookup embeds the ids in
    its rows and sums over the group, and the tied logits of each rank's
    rows are all-gathered over the vocabulary before the loss, as XLA
    gathers them."""

    def __init__(self, cfg: WhisperConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype, pdtype = _dtypes(cfg)
        self.compute_dtype = dtype
        d = cfg.n_text_state
        self.token_embedding = nn.Embedding(cfg.n_vocab, d, device=device, dtype=pdtype)
        self.positional_embedding = nn.Parameter(
            torch.empty((cfg.n_text_ctx, d), device=device, dtype=pdtype)
        )
        self.blocks = nn.ModuleList(
            TransformerBlock(
                d, cfg.n_text_head, 4 * d, has_cross_attn=True,
                causal_self_attn=True, dtype=dtype, device=device,
                param_dtype=pdtype, dropout=cfg.dropout_rate,
                gated_x_attn=bool(cfg.add_gated_x_attn),
            )
            for _ in range(cfg.n_text_layer)
        )
        self.ln = LayerNormF32(d, device=device)
        self.vocab_tp: Optional[Tuple[object, int, int]] = None

    def set_vocab_parallel(self, group, rank: int, size: int) -> None:
        """Run as part ``rank`` of ``size`` of a vocab-sharded embedding over
        ``group``; ``core/partitioning.py::shard_state`` cuts the rows."""
        self.vocab_tp = (group, rank, size)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.vocab_tp is None:
            return self.token_embedding(tokens)
        group, rank, _ = self.vocab_tp
        rows = self.token_embedding.weight.shape[0]
        local = tokens - rank * rows
        outside = (local < 0) | (local >= rows)
        emb = F.embedding(local.clamp(0, rows - 1), self.token_embedding.weight)
        emb = torch.where(outside[..., None], torch.zeros((), dtype=emb.dtype, device=emb.device),
                          emb)
        return reduce_from_group(emb, group)

    def forward(
        self,
        tokens: torch.Tensor,
        audio_features: Optional[torch.Tensor] = None,
        cache: Optional[List[Cache]] = None,
        generator: Optional[torch.Generator] = None,
        xv: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[List[Cache]]]:
        qlen = tokens.shape[1]
        x = self._embed(tokens).to(self.compute_dtype)
        x = x + positions(self.positional_embedding, cache, qlen).to(x.dtype)

        new_cache: Optional[List[Cache]] = [] if cache is not None else None
        for i, block in enumerate(self.blocks):
            x, c = block(x, enc=audio_features, cache=None if cache is None else cache[i],
                         generator=generator, xv=xv)
            if new_cache is not None:
                new_cache.append(c)
        x = self.ln(x)
        # fp32 products of the compute-dtype values, as the JAX einsum with
        # preferred_element_type=float32: the embedding is rounded to the
        # compute dtype first (a no-op when it is stored in it)
        emb = cast_param(self.token_embedding.weight, self.compute_dtype)
        if self.vocab_tp is None:
            return F.linear(x.float(), emb.float()), new_cache
        group = self.vocab_tp[0]
        logits = F.linear(copy_to_group(x.float(), group), emb.float())
        return gather_from_group(logits, group, -1), new_cache


class Whisper(nn.Module):
    """Whisper [+ Flamingo video] model: ``encode`` -> ``init_decode_cache``
    -> ``decode``.

    ``video_model`` maps lip clips [B, T, H, W(, 1)] to features [B, T,
    video_state] (the AV-HuBERT video encoder of
    :func:`~avsl_tpu_torch.models.factory.make_av_hubert_video_encoder`);
    without one, ``video`` is taken as already-extracted features.
    ``video_projection`` maps video_state to the decoder width.
    """

    def __init__(self, cfg: WhisperConfig, video_model: Optional[nn.Module] = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = WhisperEncoder(cfg, device=device)
        self.decoder = WhisperTextDecoder(cfg, device=device)
        self.video_model = video_model
        if cfg.add_gated_x_attn:
            dtype, pdtype = _dtypes(cfg)
            self.video_projection = CastLinear(cfg.video_state, cfg.n_text_state, device=device,
                                               param_dtype=pdtype, compute_dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self.decoder.token_embedding.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Whisper":
        """Random weights drawn from ``generator`` on the model's device:
        fan-in-scaled normal weights, zero biases, unit layer-norm scales,
        N(0, 0.01) decoder positions, the encoder's sinusoid table, zero
        gates, and each video-tower module's own initialisation
        (``init_from``: BatchNorm identity statistics, PReLU slopes 0.25,
        unit weight-norm scales, ``mask_emb`` from U[0, 1))."""
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)):
                w = module.weight
                w.normal_(0.0, 1.0 / math.sqrt(w[0].numel()), generator=generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                module.weight.normal_(0.0, 1.0 / math.sqrt(module.weight.shape[1]),
                                      generator=generator)
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, TransformerBlock) and module.gated_x_attn:
                module.x_attn_gate.zero_()
                module.x_mlp_gate.zero_()
            if hasattr(module, "init_from"):
                module.init_from(generator)
        self.decoder.positional_embedding.normal_(0.0, 0.01, generator=generator)
        self.encoder.reset_positional_embedding()
        return self

    def materialize(self, device, seed: int = 0) -> "Whisper":
        """Allocate a ``meta``-built model on ``device`` and fill it with
        seeded random weights (see :meth:`init_weights`)."""
        device = torch.device(device)
        self.to_empty(device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return self.init_weights(gen)

    def encode_towers(
        self,
        mel: torch.Tensor,
        video: Optional[torch.Tensor] = None,
        video_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        freeze_video_bn_stats: bool = False,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The two feature towers only (the Whisper audio encoder and the
        video model), without ``video_projection``: ``(audio_features,
        raw video features or None)``. ``video_mask`` [B, T] (True = valid
        frame) zeroes padded frames and masks them as attention keys in
        the video tower (in inference; see :mod:`.avhubert`). In training
        the tower's BatchNorm uses the batch's statistics unless
        ``freeze_video_bn_stats``."""
        features = self.encoder(mel, generator=generator)
        v = None
        if video is not None and self.cfg.add_gated_x_attn:
            if self.video_model is not None:
                v = self.video_model(
                    video=video, padding_mask=video_mask, deterministic=not self.training,
                    use_running_average=True if freeze_video_bn_stats else None,
                    generator=generator,
                )
            else:
                v = video  # already-extracted video features [B, T, video_state]
        return features, v

    def _project(self, v: torch.Tensor, scale) -> torch.Tensor:
        """``video_projection`` of raw video features, times ``scale``."""
        xv = self.video_projection(v.to(self.video_projection.compute_dtype))
        if scale is not None:
            xv = xv * torch.as_tensor(scale, dtype=xv.dtype, device=xv.device)
        return xv

    def encode(
        self,
        mel: torch.Tensor,
        video: Optional[torch.Tensor] = None,
        video_mask: Optional[torch.Tensor] = None,
        video_feature_scale=None,
        generator: Optional[torch.Generator] = None,
        freeze_video_bn_stats: bool = False,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(audio_features, x_v)``: ``x_v`` is the projected video stream
        (times ``video_feature_scale`` when given), None without video or
        gated cross-attention."""
        features, v = self.encode_towers(mel, video, video_mask, generator=generator,
                                         freeze_video_bn_stats=freeze_video_bn_stats)
        x_v = None if v is None else self._project(v, video_feature_scale)
        return features, x_v

    def decode(
        self,
        tokens: torch.Tensor,
        audio_features: Optional[torch.Tensor],
        xv: Optional[torch.Tensor] = None,
        cache: Optional[List[Cache]] = None,
    ) -> Tuple[torch.Tensor, Optional[List[Cache]]]:
        return self.decoder(tokens, audio_features, cache=cache, xv=xv)

    # Serve audio-only items of an AV model with a zeroed video tensor, as
    # the transcriber does: decoding with no "xv" cache skips the gated
    # sublayers, while training runs them on a zeroed stream.
    def init_decode_cache(
        self,
        audio_features: torch.Tensor,
        xv: Optional[torch.Tensor] = None,
        max_len: int = 0,
    ) -> List[Cache]:
        """Zeroed self-attention buffers plus the cross-attention K/V
        precomputed from the encoder output (and the gated ``x_attn`` K/V
        from ``xv`` under ``"xv"``), one entry per decoder block."""
        cfg = self.cfg
        if max_len <= 0:
            max_len = cfg.n_text_ctx
        b = audio_features.shape[0]
        head_dim = cfg.n_text_state // cfg.n_text_head
        caches: List[Cache] = []
        for block in self.decoder.blocks:
            entry: Cache = {
                "self": init_self_attn_cache(
                    b, max_len, block.attn.local_heads, head_dim,
                    torch_dtype(cfg.dtype), audio_features.device,
                ),
                "cross": block.cross_attn.precompute_kv(audio_features),
            }
            if cfg.add_gated_x_attn and xv is not None:
                entry["xv"] = block.x_attn.precompute_kv(xv)
            caches.append(entry)
        return caches

    def project_and_decode(
        self,
        tokens: torch.Tensor,
        audio_features: torch.Tensor,
        video_feats: Optional[torch.Tensor] = None,
        video_feature_scale=None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """The trainable tail of the hoisted-tower split: ``video_projection``
        (and the feature scale) and the teacher-forced decoder.
        ``project_and_decode(t, *encode_towers(mel, video))`` computes
        ``decode(t, *encode(mel, video))``."""
        xv = None
        if video_feats is not None and self.cfg.add_gated_x_attn:
            xv = self._project(video_feats, video_feature_scale)
        logits, _ = self.decoder(tokens, audio_features, generator=generator, xv=xv)
        return logits

    def forward(
        self,
        mel: torch.Tensor,
        tokens: torch.Tensor,
        video: Optional[torch.Tensor] = None,
        video_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        video_feature_scale=None,
        freeze_video_bn_stats: bool = False,
    ) -> torch.Tensor:
        """Teacher-forced logits [B, T, n_vocab] (fp32). In training mode
        every random draw comes from ``generator``."""
        features, x_v = self.encode(mel, video, video_mask, video_feature_scale,
                                    generator=generator,
                                    freeze_video_bn_stats=freeze_video_bn_stats)
        logits, _ = self.decoder(tokens, features, generator=generator, xv=x_v)
        return logits
