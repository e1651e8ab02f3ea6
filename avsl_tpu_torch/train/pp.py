"""Pipeline-parallel training: the stage-sharded state and the Whisper
encoder with its blocks pipelined.

Port of ``avsl_tpu/train/pp.py``. ``core/pipeline.py`` holds the schedule;
this module makes it trainable:

* :func:`shard_pp_state` puts a :class:`~avsl_tpu_torch.train.loop.TrainState`
  on a ``(data, stage)`` mesh: every parameter under a submodule named
  ``blocks_key`` (a :class:`~avsl_tpu_torch.core.pipeline.StackedBlocks`)
  keeps its stage's rows of the layer axis, and so do its Adam moments;
  everything else stays whole. The step (``train/loop.py``) then splits
  rows over the data group only, all-reduces gradients over the data
  group only, and adds the block slices' squared sums over the stage
  group for the gradient norm.
* :func:`whisper_encoder_pp_forward` runs the Whisper encoder with its
  block stack pipelined: the encoder's own stem modules (``conv1``,
  ``conv2``), the sinusoid positions, the blocks through
  :func:`~avsl_tpu_torch.core.pipeline.pipeline_apply` at every dropout
  0, then ``ln_post``. ``cfg.remat`` is ignored, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Union

import torch
from torch import nn

from avsl_tpu_torch.core.config import WhisperConfig
from avsl_tpu_torch.core.mesh import STAGE_AXIS, Mesh
from avsl_tpu_torch.core.partitioning import Layout
from avsl_tpu_torch.core.pipeline import (
    StackedBlocks,
    _flat,
    _nest,
    make_block_fn,
    pipeline_apply,
    stack_block_params,
)
from avsl_tpu_torch.models.layers import sinusoid_embedding
from avsl_tpu_torch.models.whisper import WhisperEncoder

__all__ = [
    "shard_pp_state",
    "split_whisper_encoder_params",
    "whisper_encoder_pp_forward",
]


def shard_pp_state(state, mesh: Mesh, blocks_key: str = "blocks"):
    """Put ``state`` on the stage mesh ``mesh`` in place: each parameter
    under a submodule named ``blocks_key`` (which must be a
    :class:`StackedBlocks`) keeps this stage's contiguous rows of dim 0,
    its Adam moments too (``ClippedAdamW.bind``); other parameters and the
    scalars stay whole. Sets ``state.layout`` and returns ``state``."""
    if getattr(state, "layout", None) is not None:
        raise ValueError("the state is already on a mesh")
    n_stages, stage = mesh.shape[STAGE_AXIS], mesh.stage_rank
    model = state.model
    holders = {name: m for name, m in model.named_modules()
               if name.split(".")[-1] == blocks_key}
    for name, module in holders.items():
        if not isinstance(module, StackedBlocks):
            raise ValueError(f"{name!r} is a {type(module).__name__}, not StackedBlocks")
        if module.n_layers % n_stages != 0:
            raise ValueError(f"{module.n_layers} layers not divisible by {n_stages} stages")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    split = {n: 0 for n in shapes if blocks_key in n.split(".")}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in split:
                per = p.shape[0] // n_stages
                p.data = p.data.narrow(0, stage * per, per).clone()
    for module in holders.values():
        per = module.n_layers // n_stages
        module.rows = (stage * per, per)
    layout = Layout(mesh, split, {}, False, shapes)
    if state.optimizer is not None:
        state.optimizer.bind(dict(model.named_parameters()), layout)
    state.layout = layout
    return state


def split_whisper_encoder_params(encoder_or_state: Union[nn.Module, Mapping[str, torch.Tensor]],
                                 n_layers: int):
    """A Whisper encoder (or its state dict) -> ``(stacked, stem)``:
    ``stacked`` the ``blocks.{i}`` tensors stacked ``[L, ...]`` (a nested
    dict, copies), ``stem`` the rest of its parameters (``conv1``,
    ``conv2``, ``ln_post``; the encoder's own tensors) as a nested dict.
    The sinusoid buffer is left out: :func:`whisper_encoder_pp_forward`
    computes it."""
    if isinstance(encoder_or_state, nn.Module):
        flat = dict(encoder_or_state.named_parameters())
    else:
        flat = {k: v for k, v in encoder_or_state.items() if k != "positional_embedding"}
    params = _nest(flat)
    with torch.no_grad():
        stacked, _ = stack_block_params(params.pop("blocks", {}), n_layers, fmt="{}")
    return stacked, params


def _templates(cfg: WhisperConfig):
    """The port's encoder modules at ``cfg``'s widths on the meta device,
    one block at dropout 0: the stem and the block whose arithmetic the
    pipelined encoder applies to the given tensors."""
    return WhisperEncoder(dataclasses.replace(cfg, n_audio_layer=1, dropout_rate=0.0),
                          device="meta").eval()


def whisper_encoder_pp_forward(cfg: WhisperConfig, stem_params: Mapping, stacked_blocks,
                               mel: torch.Tensor, *, mesh: Mesh,
                               n_microbatches: int) -> torch.Tensor:
    """The Whisper encoder on ``mel`` [B, n_mels, T] with its block stack
    pipelined over ``mesh``'s stages, ``n_microbatches`` microbatches of
    this data rank's rows: ``WhisperEncoder``'s forward at every dropout
    0, its stem and ``ln_post`` applied as the encoder's own modules to
    ``stem_params`` (from :func:`split_whisper_encoder_params`) through
    ``functional_call``. ``stacked_blocks`` is a :class:`StackedBlocks` or
    a nested dict of ``[L, ...]`` tensors."""
    enc = _templates(cfg)

    def apply(name, *args):
        return torch.func.functional_call(getattr(enc, name), _flat(stem_params[name]), args)

    x = torch.nn.functional.gelu(apply("conv1", mel.to(enc.conv1.compute_dtype)))
    x = torch.nn.functional.gelu(apply("conv2", x)).transpose(1, 2)
    pos = torch.from_numpy(sinusoid_embedding(cfg.n_audio_ctx, cfg.n_audio_state)[:x.shape[1]])
    x = x + pos.to(x.device, enc.positional_embedding.dtype)
    block_fn = (stacked_blocks.block_fn if isinstance(stacked_blocks, StackedBlocks)
                else make_block_fn(enc.blocks[0]))
    x = pipeline_apply(block_fn, stacked_blocks, x, mesh=mesh, n_microbatches=n_microbatches)
    return apply("ln_post", x)
