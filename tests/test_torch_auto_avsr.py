"""Auto-AVSR's audio-visual Conformer in the port
(``models/conformer.py``, ``train/objectives.py::auto_avsr_loss_fn``,
``cli/auto_avsr_ft.py``) held to the plain fp32 reference the benchmark
checks it with (``portbench/reference/auto_avsr.py``), at
``AutoAVSRConfig.tiny_test`` on seeded random weights: ``rel_shift``, the
positional tables, the relative-position attention with key padding, the
conv module and the Conformer block (rates 0 and 0.1 with the generator's
draws shared), the ResNet-1D's frame count, the joint loss and every
gradient, the YAML card against the config and the benchmark's file, the
CLI's ``--smoke`` run; and the shared ResNet and attention code computing
as before for AV-HuBERT and Whisper."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from avsl_tpu_torch.cli import auto_avsr_ft
from avsl_tpu_torch.core.config import AutoAVSRConfig
from avsl_tpu_torch.models import build_auto_avsr
from avsl_tpu_torch.models import conformer
from avsl_tpu_torch.models.layers import MultiHeadAttention
from avsl_tpu_torch.models.resnet3d import ChannelPReLU, ResNet3DFrontend
from avsl_tpu_torch.train.loop import batch_to_device
from avsl_tpu_torch.train.objectives import auto_avsr_loss_fn
from portbench import weights
from portbench.reference import auto_avsr as ref
from portbench.reference import whisper_flamingo as wf
from portbench.reference.precision import Precision

from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
P32 = Precision("fp32")


def _cfg(**kw):
    return AutoAVSRConfig.tiny_test(dtype="float32", **kw)


_WEIGHTS = {}


def _model(cfg, seed=5):
    """The tiny fp32 model with the benchmark's seeded weights, and a copy
    of those weights by name (drawn once a module: the draw fills large
    chunks)."""
    spec = ref.spec(dataclasses.asdict(cfg))
    key = (tuple(spec), seed)
    if key not in _WEIGHTS:
        _WEIGHTS[key] = weights.make(spec, seed, "cpu")
    W = {n: t.clone() for n, t in _WEIGHTS[key].items()}
    model = build_auto_avsr(cfg, device="cpu")
    model.load_state_dict(W)
    return model, W


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _close(a, b, tol):
    scale = float(b.abs().max().clamp_min(1e-6))
    assert float((a - b).abs().max()) <= tol * scale, float((a - b).abs().max()) / scale


def test_torch_auto_avsr_rel_shift_is_the_index_formula():
    t = 7
    x = torch.randn(2, 3, t, 2 * t - 1, generator=_gen(0))
    i = torch.arange(t)[:, None]
    j = torch.arange(t)[None, :]
    want = x[..., i, t - 1 - i + j]  # the score of relative position i - j
    assert torch.equal(conformer.rel_shift(x), want)
    assert torch.equal(ref.rel_shift(x), want)


def test_torch_auto_avsr_positional_tables():
    t, d = 6, 8
    rel = torch.from_numpy(conformer.rel_positions(t, d))
    _close(rel, ref.rel_positions(t, d, CPU), 1e-6)
    assert torch.equal(rel[t - 1, 0::2], torch.zeros(d // 2))  # position 0: sin 0, cos 0 = 1
    assert torch.equal(rel[t - 1, 1::2], torch.ones(d // 2))
    _close(torch.from_numpy(conformer.abs_positions(5, d)), ref.abs_positions(5, d, CPU), 1e-6)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_torch_auto_avsr_rel_attention_with_key_padding(rate):
    cfg = _cfg()
    model, W = _model(cfg)
    attn = model.encoder.encoders[0].self_attn.train(rate > 0)
    attn.dropout = rate
    b, t = 3, 9
    x = torch.randn(b, t, cfg.adim, generator=_gen(1))
    valid = torch.arange(t)[None, :] < torch.tensor([9, 5, 1])[:, None]
    pe = ref.rel_positions(t, cfg.adim, CPU)
    got = attn(x, pe, valid[:, None, None, :], _gen(2))
    want = ref.rel_attention(P32, x, pe, W, "encoder.encoders.0.self_attn", cfg.aheads, valid,
                             wf.Draws(_gen(2), train=True), rate)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_torch_auto_avsr_conv_module(train):
    cfg = _cfg()
    model, W = _model(cfg)
    conv = model.aux_encoder.encoders[1].conv_module.train(train)
    x = torch.randn(2, 11, cfg.adim, generator=_gen(3))
    want = ref.conv_module(P32, x, W, "aux_encoder.encoders.1.conv_module",
                           cfg.cnn_module_kernel, batch_stats=train)
    _close(conv(x), want, 1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_torch_auto_avsr_conformer_block(rate):
    cfg = _cfg(dropout_rate=rate, transformer_attn_dropout_rate=rate)
    model, W = _model(cfg)
    block = model.encoder.encoders[1].train()
    b, t = 2, 8
    x = torch.randn(b, t, cfg.adim, generator=_gen(4))
    valid = torch.arange(t)[None, :] < torch.tensor([8, 6])[:, None]
    pe = ref.rel_positions(t, cfg.adim, CPU)
    got = block(x, pe, valid[:, None, None, :], _gen(6))
    want = ref.block(P32, x, pe, W, "encoder.encoders.1", dataclasses.asdict(cfg), valid,
                     wf.Draws(_gen(6), train=True))
    _close(got, want, 1e-5)
    if rate > 0:  # the draws matter: another seed gives another block output
        other = block(x, pe, valid[:, None, None, :], _gen(7))
        assert float((other - got).abs().max()) > 1e-3


@pytest.mark.parametrize("samples,frames", [(160000, 250), (160000 + 639, 250), (1000, 1),
                                            (1285, 2)])
def test_torch_auto_avsr_resnet1d_frames(samples, frames):
    cfg = _cfg()
    model, W = _model(cfg)
    front = model.aux_encoder.frontend
    pcm = 0.1 * torch.randn(1, samples, generator=_gen(8))
    with torch.no_grad():
        got = front(pcm, use_running_average=True)
        assert got.shape == (1, frames, cfg.audio_backbone_channels)
        if samples < 2000:
            want = ref.audio_resnet(P32, W, "aux_encoder.frontend", pcm, batch_stats=False)
            _close(got, want, 1e-5)


def _batch(cfg, frames=(12, 10, 12, 9), audio_frames=None):
    """Rows of unequal length (``audio_frames`` the audio's in 640-sample
    frames, the video's when None), collated by the CLI's collator."""
    audio_frames = audio_frames or frames
    rows = auto_avsr_ft.make_synthetic_raw_av_batchset(len(frames), max(frames),
                                                       cfg.image_crop_size, cfg.odim, seed=3)
    for r, n, na in zip(rows, frames, audio_frames):
        r["audio"], r["video"] = r["audio"][: na * 640], r["video"][:n]
    return batch_to_device(auto_avsr_ft.collate_raw_av(rows, cfg.eos_id), CPU)


def test_torch_auto_avsr_joint_loss_and_every_gradient():
    _check_joint_loss(_batch(_cfg()))


def test_torch_auto_avsr_each_encoder_masks_its_own_stream():
    """Audio shorter and longer than the lips in some rows: the audio
    encoder masks by the audio's frames, the CTC and the decoder by the
    video's, in the port as in the reference."""
    _check_joint_loss(_batch(_cfg(), audio_frames=(12, 7, 11, 12)))


def _check_joint_loss(batch):
    cfg = _cfg()
    model, W = _model(cfg)
    loss, parts = auto_avsr_loss_fn(model, train=True)(batch, _gen(11))
    loss.backward()
    mb = dict(batch, dec=batch["dec_input_ids"])
    names = [n for n, p in model.named_parameters()]
    for n in names:
        W[n].requires_grad_(True)
    want, want_ctc, want_att = ref.joint_loss(P32, W, dataclasses.asdict(cfg), mb, _gen(11),
                                              parts=True)
    grads = torch.autograd.grad(want, [W[n] for n in names])
    for a, b in ((loss, want), (parts["loss_ctc"], want_ctc), (parts["loss_att"], want_att)):
        assert abs(float(a) - float(b)) <= 2e-6 * abs(float(b))
    got = dict(model.named_parameters())
    norms = {n: float(g.norm()) for n, g in zip(names, grads)}
    median = float(np.median(list(norms.values())))
    gaps = {n: float((got[n].grad - g).norm()) / max(norms[n], median)
            for n, g in zip(names, grads)}
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= 1e-4, (worst, gaps[worst])


def test_torch_auto_avsr_runs_no_fused_attention(monkeypatch):
    """Every attention of the model takes the einsum path (the score term,
    the decoder's masks), in training and in eval: K1/K2 never launch."""
    from avsl_tpu_torch.models import layers

    def refuse(*a, **kw):
        raise AssertionError("fused_attention called")

    monkeypatch.setattr(layers, "fused_attention", refuse)
    cfg = _cfg()
    model, _ = _model(cfg)
    batch = _batch(cfg)
    auto_avsr_loss_fn(model, train=True)(batch, _gen(14))[0].backward()
    with torch.no_grad():
        auto_avsr_loss_fn(model, train=False)(batch, None)


def test_torch_auto_avsr_ctc_recursion_is_torch_ctc():
    logits = torch.randn(3, 20, 7, generator=_gen(12))
    targets = torch.tensor([[1, 2, 2, 3], [4, 5, 0, 0], [6, 6, 6, 0]])
    tl, lengths = torch.tensor([4, 2, 3]), torch.tensor([20, 15, 5])  # the last infeasible
    got = ref.ctc_loss(logits, lengths, targets, tl)
    want = conformer.ctc_loss_sum(logits, lengths, targets, tl)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_torch_auto_avsr_yaml_config_and_benchmark_file():
    cfg = AutoAVSRConfig.from_yaml(str(REPO / "configs" / "auto_avsr_av.yaml"))
    assert cfg == AutoAVSRConfig()
    bench = json.loads((REPO / "portbench" / "configs" / "auto_avsr_av.json").read_text())
    assert AutoAVSRConfig.from_dict(bench["model"]) == cfg
    assert bench["reduced"] == []
    with pytest.raises(ValueError):
        AutoAVSRConfig.from_dict({"adim": 768, "aux_adim": 512})
    with pytest.raises(ValueError):
        AutoAVSRConfig.from_dict({"rel_pos_type": "legacy"})
    n = sum(p.numel() for p in conformer.AutoAVSR(cfg, device="meta").parameters())
    assert 0.43e9 < n < 0.45e9


def test_torch_auto_avsr_cli_smoke(capsys):
    out = auto_avsr_ft.main(["--smoke", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out and out["steps"] == 4
    for key in ("first_loss", "last_loss", "eval_loss", "eval_loss_ctc", "eval_loss_att"):
        assert np.isfinite(out[key]), key


def test_torch_auto_avsr_shared_code_as_before():
    """The ResNet's PReLU and ReLU and the attention's Whisper and fairseq
    names are what AV-HuBERT and Whisper build, and the PReLU frontend
    computes the reference's AV-HuBERT ResNet; swish is Auto-AVSR's."""
    prelu = ResNet3DFrontend(8, 32, "prelu", dtype=torch.float32)
    assert isinstance(prelu.frontend3D[2], ChannelPReLU)
    assert not any(isinstance(m, torch.nn.SiLU) for m in prelu.modules())
    relu = ResNet3DFrontend(8, 32, "relu", dtype=torch.float32)
    assert isinstance(relu.trunk.layer1[0].relu1, torch.nn.ReLU)
    assert isinstance(ResNet3DFrontend(8, 32, "swish").frontend3D[2], torch.nn.SiLU)
    names = {n for n, _ in MultiHeadAttention(8, 2, names="whisper").named_parameters()}
    assert names == {f"{p}.{k}" for p in ("query", "value", "out") for k in ("weight", "bias")} \
        | {"key.weight"}
    names = {n for n, _ in MultiHeadAttention(8, 2, names="fairseq",
                                              use_k_bias=True).named_parameters()}
    assert names == {f"{p}.{k}" for p in ("q_proj", "k_proj", "v_proj", "out_proj")
                     for k in ("weight", "bias")}
    # the PReLU frontend against the reference's AV-HuBERT ResNet
    spec = [(f"r.{n}", s, k) for n, s, k in _resnet_spec(8, 32)]
    W = weights.make(spec, 9, "cpu")
    prelu.load_state_dict({n[2:]: t for n, t in W.items()})
    video = torch.randn(2, 3, 24, 24, generator=_gen(13))
    with torch.no_grad():
        _close(prelu(video), wf.resnet(P32, W, "r", video, batch_stats=False), 1e-5)
    lip = ResNet3DFrontend(8, 32, "swish", dtype=torch.float32)
    lip.load_state_dict({n[2:]: t for n, t in W.items() if "relu" not in n and
                         "frontend3D.2" not in n})
    with torch.no_grad():
        _close(lip(video), ref.lip_resnet(P32, W, "r", video, batch_stats=False), 1e-5)


def _resnet_spec(c0, bc):
    from portbench.reference.spec import _bn

    out = [("frontend3D.0.weight", (c0, 1, 5, 7, 7), "fan_in")]
    _bn(out, "frontend3D.1", c0)
    out.append(("frontend3D.2.weight", (c0,), "prelu"))
    c_in = c0
    for stage, width in enumerate((max(bc // 8, 8), max(bc // 4, 8), max(bc // 2, 8), bc), 1):
        for blk in range(2):
            pre = f"trunk.layer{stage}.{blk}"
            out.append((f"{pre}.conv1.weight", (width, c_in, 3, 3), "fan_in"))
            _bn(out, f"{pre}.bn1", width)
            out.append((f"{pre}.relu1.weight", (width,), "prelu"))
            out.append((f"{pre}.conv2.weight", (width, width, 3, 3), "fan_in"))
            _bn(out, f"{pre}.bn2", width)
            out.append((f"{pre}.relu2.weight", (width,), "prelu"))
            if blk == 0 and (stage > 1 or c_in != width):
                out.append((f"{pre}.downsample.0.weight", (width, c_in, 1, 1), "fan_in"))
                _bn(out, f"{pre}.downsample.1", width)
            c_in = width
    return out
