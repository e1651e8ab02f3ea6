"""LoRA training and export through the port's entry points (CPU, fp32).

Three accumulated LoRA train steps (2 micro-batches of 2, lip video, every
tower rate 0, BatchNorm on batch statistics) of the port's
``make_train_step`` over a ``LoraModel`` with ``lora_optimizer`` against
``avsl_tpu.train.make_train_step`` over JAX's ``lora_loss_fn`` with its
``lora_optimizer``, on JAX's adapters carried across: loss and grad_norm
per step rtol 2e-5, the adapters after 3 steps atol 1e-5 (as the Flamingo
train test), every base tensor bit-identical, running statistics atol
1e-5. Then ``cli.finetune --smoke`` with ``lora_rank: 4`` (an
adapter-sized checkpoint), and ``cli.export_lora``: the written
checkpoint equals the merge (rtol 1e-5, atol 1e-6, JAX's test), keeps
every other tensor, refuses a base directory with no checkpoint, and
``cli.transcribe --ckpt_dir`` serves it. Last, the port's adapter set at
the large-v2 audio-visual schema equals JAX's (paths from
``jax.eval_shape`` of ``init``, nothing allocated).
"""

import copy
import dataclasses
import re

import numpy as np
import pytest
import scipy.io.wavfile as wavfile
import torch
import yaml

import jax
import jax.numpy as jnp

from avsl_tpu.core.config import FlamingoTrainConfig as JaxTrainConfig
from avsl_tpu.core.tree import path_str
from avsl_tpu.models import lora as jlora
from avsl_tpu.models.factory import build_whisper_flamingo as jax_build
from avsl_tpu.train import TrainState as JaxTrainState
from avsl_tpu.train import make_train_step as jax_make_train_step
from avsl_tpu.train.objectives import flamingo_loss_fn as jax_loss_fn
from avsl_tpu.train.optim import lora_optimizer as jax_lora_optimizer
from avsl_tpu_torch.core.config import AVHuBERTConfig, FlamingoTrainConfig, WhisperConfig
from avsl_tpu_torch.models import lora
from avsl_tpu_torch.models.convert import flax_path_to_torch_key
from avsl_tpu_torch.models.factory import make_av_hubert_video_encoder
from avsl_tpu_torch.models.whisper import Whisper
from avsl_tpu_torch.train import TrainState, flamingo_loss_fn, lora_optimizer, make_train_step
from avsl_tpu_torch.train.checkpoints import restore_params_only, save_checkpoint
from test_torch_flamingo_common import (  # noqa: F401 (fixture)
    assert_batch_stats_close,
    carried_flamingo,
    one_torch_thread,
)
from test_torch_flamingo_loss import make_batch
from test_torch_lora import jax_adapters

TRAIN_CFG = dict(learning_rate=1e-3, warmup_steps=1, num_train_steps=20, add_gated_x_attn=1,
                 prob_use_av=1.0, prob_use_a=0.5)
MIXING = dict(prob_av=1.0, prob_a=0.5)


def test_torch_lora_train_steps_match_jax():
    jmodel, variables, port, cfg = carried_flamingo(seed=2)
    params = variables["params"]
    tree = jax_adapters(params, rank=4, seed=5)
    tx, _ = jax_lora_optimizer(tree, JaxTrainConfig(**TRAIN_CFG), 20)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, tree), tx,
                                  batch_stats=variables["batch_stats"])
    jstep = jax_make_train_step(
        jlora.lora_loss_fn(jax_loss_fn(jmodel, train=True, **MIXING), params, 8.0, 4), tx,
        grad_accum_steps=2, donate=False)
    model = lora.LoraModel(port, lora.lora_from_flax(tree), alpha=8.0, rank=4)
    opt, labels = lora_optimizer(model, FlamingoTrainConfig(**TRAIN_CFG), 20)
    assert opt.weight_decay == 0.0 and set(opt.names) == set(labels)
    assert len(opt.names) == 2 * len(tree_paths := list(lora.lora_from_flax(tree)))
    pstate = TrainState.create(model, opt)
    pstep = make_train_step(lora.lora_loss_fn(flamingo_loss_fn(port, train=True, **MIXING), model),
                            grad_accum_steps=2, param_labels=labels)
    base0 = {n: p.detach().clone() for n, p in port.named_parameters()}
    rng = np.random.default_rng(6)
    for i in range(3):
        batch = make_batch(cfg, rng, lead=(2, 2))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, pm = pstep(pstate, batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=2e-5,
                                       err_msg=f"{key} step {i + 1}")
    want = lora.lora_from_flax(jax.device_get(jstate.params))
    for path in tree_paths:
        for name, table in (("lora_a", model.lora_a), ("lora_b", model.lora_b)):
            np.testing.assert_allclose(table[path].detach().numpy(), want[path][name].numpy(),
                                       atol=1e-5, rtol=0, err_msg=f"{path}/{name}")
    assert all(torch.equal(p, base0[n]) for n, p in port.named_parameters())
    assert all(not p.requires_grad for p in port.parameters())
    assert_batch_stats_close(port, jstate.batch_stats, atol=1e-5)


def _yaml(tmp_path, **keys):
    path = tmp_path / "lora.yaml"
    path.write_text(yaml.safe_dump({"log_output_dir": str(tmp_path / "logs"),
                                    "check_output_dir": str(tmp_path / "ckpt"),
                                    "train_id": "lora_smoke", **keys}))
    return str(path)


def test_torch_finetune_cli_lora_smoke(tmp_path):
    """The runner on adapter-sized state: train steps, validation,
    checkpoints that hold the adapters and BatchNorm statistics only."""
    from avsl_tpu_torch.cli.finetune import main

    result = main([_yaml(tmp_path, lora_rank=4, lora_alpha=8.0), "--smoke", "--device", "cpu"])
    assert result["final_step"] == 6 and np.isfinite(result["best_wer"])
    saved = restore_params_only(str(tmp_path / "ckpt" / "lora_smoke"))
    assert saved and all(k.startswith(("lora_a.", "lora_b.", "batch_stats.")) for k in saved)
    assert any(k.startswith("lora_b.") and v.any() for k, v in saved.items())


def test_torch_export_lora_cli_merges_exactly_and_serves(tmp_path):
    from avsl_tpu_torch.cli import export_lora, transcribe
    from avsl_tpu_torch.cli.avg_ckpt import build_state
    from avsl_tpu_torch.cli.finetune import make_lora

    cfg = FlamingoTrainConfig(model_name="test", audio_max_length=16000, lora_rank=4,
                              lora_alpha=8.0)
    base = build_state(cfg, smoke=True, device="cpu")
    with torch.no_grad():
        for p in base.model.parameters():
            p.add_(0.01)
    save_checkpoint(str(tmp_path / "base"), base, 0)
    model = make_lora(cfg, copy.deepcopy(base.model))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.03 * torch.randn(p.shape, generator=gen))
    opt, _ = lora_optimizer(model, cfg, 1)
    save_checkpoint(str(tmp_path / "adapters"), TrainState(model, opt, step=7), 7)
    expect = model.merged_weights()
    args = ["--config", _yaml(tmp_path, lora_rank=4, lora_alpha=8.0), "--adapter_ckpt",
            str(tmp_path / "adapters"), "--output", str(tmp_path / "merged"), "--smoke",
            "--device", "cpu"]
    with pytest.raises(SystemExit, match="no base checkpoint"):
        export_lora.main(args + ["--base_ckpt", str(tmp_path / "nothing")])
    out = export_lora.main(args + ["--base_ckpt", str(tmp_path / "base")])
    assert out.step == 7
    merged = restore_params_only(str(tmp_path / "merged"), 7)
    base_sd = base.model.state_dict()
    assert sorted(merged) == sorted(base_sd) and len(expect) > 4
    for key, value in merged.items():
        want = expect.get(key, base_sd[key])
        np.testing.assert_allclose(value.numpy(), want.detach().numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    seg = tmp_path / "segs"
    seg.mkdir()
    x = 0.2 * np.sin(2 * np.pi * 220 * np.arange(16000) / 16000)
    wavfile.write(str(seg / "seg0.wav"), 16000, (x * 32767).astype(np.int16))
    served = transcribe.main(["--input", str(seg), "--smoke", "--device", "cpu",
                              "--ckpt_dir", str(tmp_path / "merged"), "--max_new_tokens", "4"])
    assert [r["id"] for r in served] == ["seg0"] and np.isfinite(served[0]["avg_logprob"])


def test_torch_lora_adapter_set_at_large_v2_av_schema():
    """JAX's adapter paths over the published large-v2 + AV-HuBERT large
    tree, without allocating it, against the port's over its model built
    on the meta device; every 2-D path of JAX's tree maps to a port key
    and back."""
    jmodel, jcfg = jax_build("large-v2", vocab_size=51866, dtype="bfloat16")
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, jcfg.n_mels, 3000)),
                            jnp.zeros((1, 4), jnp.int32), video=jnp.zeros((1, 10, 88, 88, 1))))
    two_d = {path_str(p) for p, leaf in jax.tree_util.tree_leaves_with_path(shapes["params"])
             if len(leaf.shape) == 2}
    want = sorted(p for p in two_d if any(re.search(t, p) for t in jlora.DEFAULT_TARGETS))
    w_cfg = dataclasses.replace(WhisperConfig.from_name("large-v2"), n_vocab=51866,
                                add_gated_x_attn=1, video_state=1024)
    meta = Whisper(w_cfg, video_model=make_av_hubert_video_encoder(AVHuBERTConfig(),
                                                                    device="meta"), device="meta")
    got = lora.target_paths(meta, lora.DEFAULT_TARGETS)
    assert got == want and len(got) == 2 * (32 + 3 * 32 + 24)
    for path in two_d:
        assert lora.flax_path(flax_path_to_torch_key(path)) == path
    assert {lora.flax_path(k) for k, p in meta.named_parameters() if p.ndim == 2} == two_d
