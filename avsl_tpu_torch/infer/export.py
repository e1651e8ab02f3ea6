"""Serialized serving programs: the transcriber's device work as
``torch.export`` programs with the weights embedded, replayed without
model code.

Port of ``avsl_tpu/infer/export.py`` (``export_serving_program``,
``load_exported``). The JAX package exports one StableHLO program, decode
loop included. The port's decode loops run on the host (a Python loop
with one host read a step), and tracing one would freeze its index into
a constant; so the port exports the model code as two programs and keeps
the decode strategy, which is not model code, on the host:

* ``encode``: ``(audio [B, samples] f32, video [B, frames, crop, crop, 1]
  f32)`` -> the decode cache as a flat tuple of tensors: log-mel, the
  encoders (K1 in every encoder block, the custom op
  ``avsl_tpu_torch::flash_attn_fwd``), the cross-attention and "xv" K/V,
  int8 rows with ``kv_int8``, and zeroed self-attention buffers;
* ``step``: ``(tokens [N, Q] int64, index [N] int64, *cache)`` -> logits
  [N, Q, vocab] f32, one decode step through the vector-index self cache
  (``models/layers.py``), written in place; ``Q`` is dynamic, ``N`` is
  the batch (times the beam width with a beam).

With a draft model, ``draft_encode`` (``(audio,)``) and ``draft_step``
follow. The weights are embedded as the transcriber holds them (int8 with
``quantize``). :func:`load_exported` drives the step program with the
port's own greedy, beam or speculative decode. The temperature fallback
is the host's and is not exported (the manifest lists it).

Artifact layout: the directory ``<path>`` holds one subdirectory per
platform (``cuda``, ``cpu``; a program runs where it was traced) with the
programs' ``.pt2`` files and
``layout.json`` (each decoder layer's cache entries, in the order the
programs pass them), and ``<path>.json`` the manifest (JAX's keys,
``format`` ``"torch.export"``), so a runtime can check its feeds before
it loads gigabytes.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from avsl_tpu_torch.core.device import resolve_device
from avsl_tpu_torch.decode.beam import beam_search
from avsl_tpu_torch.decode.greedy import greedy_decode_scored
from avsl_tpu_torch.decode.speculative import speculative_greedy_decode
from avsl_tpu_torch.models.quant import QTensor

PLATFORMS = ("cuda", "cpu")


def cache_layout(cache: List[Dict[str, Any]]) -> List[List[List]]:
    """Per decoder layer, its entries in order, each ``[name, is int8]``."""
    return [[[name, isinstance(sub["k"], QTensor)] for name, sub in entry.items()]
            for entry in cache]


def flatten_cache(cache: List[Dict[str, Any]]) -> List[torch.Tensor]:
    """The cache's tensors in :func:`cache_layout` order (an int8 K or V as
    its ``q`` then its ``scale``), without the self-attention index."""
    flat: List[torch.Tensor] = []
    for entry in cache:
        for sub in entry.values():
            for x in (sub["k"], sub["v"]):
                flat.extend(x if isinstance(x, QTensor) else (x,))
    return flat


def unflatten_cache(flat: Sequence[torch.Tensor], layout, index) -> List[Dict[str, Any]]:
    """:func:`flatten_cache`'s inverse, every self-attention entry at ``index``."""
    it = iter(flat)

    def take(quantized):
        return QTensor(next(it), next(it)) if quantized else next(it)

    cache = []
    for entry in layout:
        out = {}
        for name, quantized in entry:
            out[name] = {"k": take(quantized), "v": take(quantized)}
            if name == "self":
                out[name]["index"] = index
        cache.append(out)
    return cache


class _Encode(nn.Module):
    """audio (and video) -> the flat decode cache of the transcriber's
    model, or of its draft. It holds only what that runs (the encoders,
    the video projection, the cross-attention and "xv" projections), so
    the program embeds no decoder weight it does not read."""

    def __init__(self, transcriber, draft: bool):
        super().__init__()
        self.tr, self.draft = transcriber, draft
        model = transcriber.draft_model if draft else transcriber.model
        used = [model.encoder, getattr(model, "video_model", None),
                getattr(model, "video_projection", None)]
        for block in model.decoder.blocks:
            used += [block.cross_attn, getattr(block, "x_attn", None)]
        self.used = nn.ModuleList(m for m in used if m is not None)

    def cache(self, audio, video=None):
        tr = self.tr
        if self.draft:
            return tr.draft_model.init_decode_cache(tr.encode_draft(audio), None, tr.cache_len())
        return tr.decode_cache(*tr.encode(audio, video), tr.cache_len())

    def forward(self, audio, video=None):
        return tuple(flatten_cache(self.cache(audio, video)))


class _Step(nn.Module):
    """One cached decode step of a Whisper decoder over the flat cache."""

    def __init__(self, decoder, layout):
        super().__init__()
        self.decoder, self.layout = decoder, layout

    def forward(self, tokens, index, *flat):
        logits, _ = self.decoder(tokens, None, cache=unflatten_cache(flat, self.layout, index))
        return logits


def _export_pair(transcriber, draft: bool, audio, video, batch: int):
    """(encode program, step program, cache layout) of the target or the
    draft, traced on ``audio``/``video`` and on a step over the prompt at
    ``batch`` rows (the batch times the beam width)."""
    from torch.export import Dim, export

    enc = _Encode(transcriber, draft)
    args = (audio,) if draft else (audio, video)
    cache = enc.cache(*args)
    layout = cache_layout(cache)
    enc_prog = export(enc, args)
    rep = batch // audio.shape[0]
    flat = [x.repeat_interleave(rep, dim=0) for x in flatten_cache(cache)]
    prompt = transcriber._prompt.repeat_interleave(rep, dim=0)
    index = torch.zeros((batch,), dtype=torch.int64, device=audio.device)
    decoder = (transcriber.draft_model if draft else transcriber.model).decoder
    # the query length is dynamic (the prompt, one token, a verify pass),
    # and so is the batch under a beam, which warms the cache at B rows,
    # then steps B * K; Dim.DYNAMIC keeps the guards the card's bf16
    # product adds on them (it cannot prove them) as checks at run time
    rows = {0: Dim.DYNAMIC} if rep > 1 else None
    step_prog = export(_Step(decoder, layout), (prompt, index, *flat),
                       dynamic_shapes=({**(rows or {}), 1: Dim.DYNAMIC}, rows,
                                       (rows,) * len(flat)))
    return enc_prog, step_prog, layout


def check_platforms(platforms: Sequence[str]) -> None:
    """Raise for a platform the port does not export for, and for
    ``cuda`` without a card."""
    for p in platforms:
        if p not in PLATFORMS:
            raise ValueError(f"platform {p!r}: the port exports for {list(PLATFORMS)}")
        resolve_device(p)


def export_serving_program(transcriber, path: str,
                           platforms: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Export ``transcriber``'s device work (see the module docstring) to
    ``<path>/<platform>/`` with a ``<path>.json`` manifest. A program runs
    on the platform it was traced on (the model code takes device-specific
    paths, the card's bf16 products among them), so ``platforms`` (the
    transcriber's device when None) may name only that device; the CLI
    exports for another by building the transcriber there. Returns the
    manifest. A transcriber on a mesh is refused, as in JAX."""
    from torch.export import save

    if getattr(transcriber, "mesh", None) is not None:
        raise ValueError(
            "cannot export a mesh-sharded transcriber: the program would hold one rank's "
            "slice of the weights and its collectives; export a transcriber without a mesh")
    here = transcriber.device.type
    platforms = list(platforms) if platforms else [here]
    check_platforms(platforms)
    if platforms != [here]:
        raise ValueError(f"a transcriber on {here!r} exports for {here!r} only, not {platforms}: "
                         "build it on each platform to export there")
    b = transcriber.batch_size
    dev = transcriber.device
    audio = torch.zeros((b, transcriber.audio_max_length), dtype=torch.float32, device=dev)
    video = torch.zeros((b, transcriber.video_frames, transcriber.crop, transcriber.crop, 1),
                        dtype=torch.float32, device=dev)
    programs = {}
    with transcriber.serving_mode(), torch.no_grad():
        enc, step, layout = _export_pair(transcriber, False, audio, video,
                                         b * transcriber.beam_size)
        programs.update(encode=enc, step=step)
        draft_layout = None
        if transcriber.draft_model is not None:
            denc, dstep, draft_layout = _export_pair(transcriber, True, audio, video, b)
            programs.update(draft_encode=denc, draft_step=dstep)

    total = 0
    os.makedirs(os.path.join(path, here), exist_ok=True)
    for name, prog in programs.items():
        prog.example_inputs = None  # the traced inputs (the whole cache) are not saved
        f = os.path.join(path, here, f"{name}.pt2")
        save(prog, f)
        total += os.path.getsize(f)

    prompt = transcriber._prompt
    spec = transcriber.draft_model is not None
    manifest = {
        "format": "torch.export",
        "platforms": platforms,
        "calling_convention_version": torch.__version__,
        "inputs": [
            {"name": "audio", "shape": list(audio.shape), "dtype": "float32"},
            {"name": "video", "shape": list(video.shape), "dtype": "float32"},
            {"name": "prompt", "shape": list(prompt.shape), "dtype": "int64"},
        ],
        "outputs": ("(tokens [B, max_new_tokens] int64, avg_logprob [B] f32)"
                    if transcriber.beam_size == 1
                    else "(tokens [B, max_new_tokens] int64, beam_score [B] f32)")
        + (" + (accept_rate [] f32, rounds int)" if spec else ""),
        "eot_id": int(transcriber.tokenizer.eot),
        "lang": transcriber.lang,
        "beam_size": transcriber.beam_size,
        "max_new_tokens": transcriber.max_new_tokens,
        "quantize": transcriber.quantize,
        "kv_int8": transcriber.kv_int8,
        "speculative": spec,
        "spec_k": transcriber.spec_k if spec else None,
        "host_side_not_exported": ["temperature_fallback"] if transcriber.temperature_fallback
        else [],
        "bytes": total,
    }
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=2)
    with open(os.path.join(path, "layout.json"), "w") as f:
        json.dump({"cache": layout, "draft_cache": draft_layout}, f)
    return manifest


def load_exported(path: str, device: Optional[str] = None):
    """Load an exported serving program; returns ``(call, manifest)``,
    where ``call(audio, video, prompt)`` (tensors on the program's device)
    runs the encode program and drives the step program with the port's
    greedy, beam or speculative decode, as the manifest says. ``device``:
    the platform to load (the card unless "cpu" is asked for)."""
    import avsl_tpu_torch.kernels.attention  # noqa: F401  registers the K1 custom op
    from torch.export import load

    platform = resolve_device(device or "cuda").type
    with open(path + ".json") as f:
        manifest = json.load(f)
    with open(os.path.join(path, "layout.json")) as f:
        layout = json.load(f)
    if platform not in manifest["platforms"]:
        raise ValueError(f"{path} holds programs for {manifest['platforms']}, not {platform!r}")
    progs = {name: load(os.path.join(path, platform, f"{name}.pt2")).module()
             for name in (("encode", "step", "draft_encode", "draft_step")
                          if manifest["speculative"] else ("encode", "step"))}
    eot, max_new = manifest["eot_id"], manifest["max_new_tokens"]

    def stepper(step_prog):
        def step(tokens, cache):
            index = cache[0]["self"]["index"]
            logits = step_prog(tokens, index, *flatten_cache(cache))
            return logits, [{**e, "self": {**e["self"], "index": index + tokens.shape[1]}}
                            for e in cache]
        return step

    def start(enc_prog, layout, args, batch):
        flat = enc_prog(*args)
        index = torch.zeros((batch,), dtype=torch.int64, device=flat[0].device)
        return unflatten_cache(flat, layout, index)

    def call(audio, video, prompt):
        with torch.inference_mode():
            b = audio.shape[0]
            cache = start(progs["encode"], layout["cache"], (audio, video), b)
            step = stepper(progs["step"])
            if manifest["beam_size"] > 1:
                return beam_search(step, cache, prompt, manifest["beam_size"], max_new, eot)
            if manifest["speculative"]:
                dcache = start(progs["draft_encode"], layout["draft_cache"], (audio,), b)
                res = speculative_greedy_decode(step, stepper(progs["draft_step"]), cache, dcache,
                                                prompt, max_new, eot, k=manifest["spec_k"])
                return res.tokens, res.avg_logprob, res.accept_rate, res.rounds
            return greedy_decode_scored(step, cache, prompt, max_new, eot)

    return call, manifest
