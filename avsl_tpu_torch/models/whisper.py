"""Whisper encoder/decoder in PyTorch (audio-only).

Port of ``WhisperEncoder``, ``WhisperTextDecoder`` and the ``Whisper``
methods ``encode``, ``encode_towers``, ``project_and_decode``, ``decode``
and ``init_decode_cache`` from ``avsl_tpu/models/whisper.py``, with the
OpenAI state-dict names. Linear, convolution and embedding weights live
in ``cfg.param_dtype`` and are cast to the compute dtype ``cfg.dtype`` at
use when the two differ (training: fp32 weights, bf16 compute); layer
norms are fp32. In training mode (``model.train()``) each block applies
residual dropout at ``cfg.dropout_rate`` with masks drawn from the
``generator`` the forward is given. The gated video cross-attention
(``add_gated_x_attn``) and ``video_projection`` belong to the
audio-visual slice and are not here yet.

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
from avsl_tpu_torch.models.layers import (
    Cache,
    CastConv1d,
    LayerNormF32,
    TransformerBlock,
    cast_param,
    init_self_attn_cache,
    sinusoid_embedding,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"dtype {name!r} not supported; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


def _video_not_ported():
    return NotImplementedError(
        "add_gated_x_attn=1 and video inputs need the gated video "
        "cross-attention and the AV-HuBERT tower: slice 3 of the port "
        "(ROADMAP.md queue 1, items 6-7)"
    )


def _dtypes(cfg: WhisperConfig) -> Tuple[torch.dtype, torch.dtype]:
    """(compute dtype, parameter dtype) of ``cfg``."""
    return torch_dtype(cfg.dtype), torch_dtype(cfg.param_dtype)


class WhisperEncoder(nn.Module):
    """Audio encoder: mel [B, n_mels, T] -> features [B, T//2, n_audio_state]."""

    def __init__(self, cfg: WhisperConfig, device=None):
        super().__init__()
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
        for block in self.blocks:
            x, _ = block(x, generator=generator)
        return self.ln_post(x)


class WhisperTextDecoder(nn.Module):
    """Text decoder with learned positions and logits tied to the token
    embedding (fp32 logits)."""

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
            )
            for _ in range(cfg.n_text_layer)
        )
        self.ln = LayerNormF32(d, device=device)

    def forward(
        self,
        tokens: torch.Tensor,
        audio_features: Optional[torch.Tensor] = None,
        cache: Optional[List[Cache]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Optional[List[Cache]]]:
        n_ctx, qlen = self.cfg.n_text_ctx, tokens.shape[1]
        x = self.token_embedding(tokens).to(self.compute_dtype)
        # dynamic_slice semantics: the start clamps so the slice fits
        start = 0
        if cache is not None:
            start = max(0, min(int(cache[0]["self"]["index"]), n_ctx - qlen))
        x = x + self.positional_embedding[start:start + qlen].to(x.dtype)

        new_cache: Optional[List[Cache]] = [] if cache is not None else None
        for i, block in enumerate(self.blocks):
            x, c = block(x, enc=audio_features, cache=None if cache is None else cache[i],
                         generator=generator)
            if new_cache is not None:
                new_cache.append(c)
        x = self.ln(x)
        # fp32 products of the compute-dtype values, as the JAX einsum with
        # preferred_element_type=float32: the embedding is rounded to the
        # compute dtype first (a no-op when it is stored in it)
        emb = cast_param(self.token_embedding.weight, self.compute_dtype)
        logits = F.linear(x.float(), emb.float())
        return logits, new_cache


class Whisper(nn.Module):
    """Audio-only Whisper: ``encode`` -> ``init_decode_cache`` -> ``decode``."""

    def __init__(self, cfg: WhisperConfig, device=None):
        super().__init__()
        if cfg.add_gated_x_attn:
            raise _video_not_ported()
        self.cfg = cfg
        self.encoder = WhisperEncoder(cfg, device=device)
        self.decoder = WhisperTextDecoder(cfg, device=device)

    @property
    def device(self) -> torch.device:
        return self.decoder.token_embedding.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Whisper":
        """Random weights drawn from ``generator`` on the model's device:
        fan-in-scaled normal weights, zero biases, unit layer-norm scales,
        N(0, 0.01) decoder positions and the encoder's sinusoid table."""
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Conv1d)):
                w = module.weight
                fan_in = w.shape[1] * (w.shape[2] if w.ndim == 3 else 1)
                w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                module.weight.normal_(0.0, 1.0 / math.sqrt(module.weight.shape[1]),
                                      generator=generator)
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
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
        self, mel: torch.Tensor, video: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, None]:
        if video is not None:
            raise _video_not_ported()
        return self.encoder(mel), None

    def encode(
        self, mel: torch.Tensor, video: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, None]:
        """``(audio_features, x_v)``; ``x_v`` is None on the audio-only path."""
        return self.encode_towers(mel, video)

    def decode(
        self,
        tokens: torch.Tensor,
        audio_features: Optional[torch.Tensor],
        xv: Optional[torch.Tensor] = None,
        cache: Optional[List[Cache]] = None,
    ) -> Tuple[torch.Tensor, Optional[List[Cache]]]:
        if xv is not None:
            raise _video_not_ported()
        return self.decoder(tokens, audio_features, cache=cache)

    def init_decode_cache(
        self,
        audio_features: torch.Tensor,
        xv: Optional[torch.Tensor] = None,
        max_len: int = 0,
    ) -> List[Cache]:
        """Zeroed self-attention buffers plus the cross-attention K/V
        precomputed from the encoder output, one entry per decoder block."""
        if xv is not None:
            raise _video_not_ported()
        cfg = self.cfg
        if max_len <= 0:
            max_len = cfg.n_text_ctx
        b = audio_features.shape[0]
        head_dim = cfg.n_text_state // cfg.n_text_head
        return [
            {
                "self": init_self_attn_cache(
                    b, max_len, cfg.n_text_head, head_dim,
                    torch_dtype(cfg.dtype), audio_features.device,
                ),
                "cross": block.cross_attn.precompute_kv(audio_features),
            }
            for block in self.decoder.blocks
        ]

    def project_and_decode(
        self,
        tokens: torch.Tensor,
        audio_features: torch.Tensor,
        video_feats: Optional[torch.Tensor] = None,
        video_feature_scale: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """The trainable tail of the hoisted-tower split: teacher-forced
        logits from precomputed audio features. ``project_and_decode(t,
        *encode_towers(mel))`` computes ``decode(t, *encode(mel))``; on the
        audio-only path there is no video projection."""
        if video_feats is not None or video_feature_scale is not None:
            raise _video_not_ported()
        logits, _ = self.decoder(tokens, audio_features, generator=generator)
        return logits

    def forward(
        self,
        mel: torch.Tensor,
        tokens: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Teacher-forced logits [B, T, n_vocab] (fp32). In training mode
        dropout masks come from ``generator``."""
        features = self.encoder(mel, generator=generator)
        logits, _ = self.decoder(tokens, features, generator=generator)
        return logits
