"""The video tower in training against the JAX one (CPU, fp32).

* ``BatchNormF32`` on batch statistics against flax's ``BatchNorm(
  momentum=0.9, dtype=float32)`` over 3 micro-steps of clips with padded
  (zero) frames: outputs, the input gradient and the running statistics
  atol 1e-5 (fp32 sums in other orders); ``F.batch_norm``'s own training
  update, which keeps the unbiased variance, misses by far more;
* the AV-HuBERT video encoder in training with every rate 0, with and
  without a ``video_mask`` (a length-0 row included): features atol 1e-4
  (as the inference tests), the updated running statistics atol 1e-5, and
  the gradient of every parameter after the ResNet atol 1e-4 + rtol 1e-3
  (fp32, other summation orders). Inside the ResNet the backward runs
  through up to 17 batch-statistics BatchNorms, whose projections cancel:
  on these weights JAX's and the port's fp32 gradients there differ by up
  to 3 %, and scaling the incoming gradient by 0.1 instead of scaling the
  result moves the port's own by up to 8e-4, so the ResNet is held port
  against port: ``feature_grad_mult`` 0.1 gives 0.1 times the gradients
  of ``feature_grad_mult`` 1 (atol 1e-4 + rtol 1e-3), the rest identical;
* attention dropout at 1e-12, which rounds to keep-all in fp32 on both
  sides, with key lengths given: both packages take the unfused path,
  which ignores the lengths (a partly padded row differs from the masked
  eval output, the full row does not);
* modality dropout at probability 1, dropping the video or (audio
  dropout 1) the absent audio.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as fnn
import jax
import jax.numpy as jnp

from avsl_tpu.core.config import AVHuBERTConfig as JaxAVHuBERTConfig
from avsl_tpu.models.factory import make_av_hubert_video_encoder as jax_video_encoder
from avsl_tpu_torch.core.config import AVHuBERTConfig
from avsl_tpu_torch.models import make_av_hubert_video_encoder
from avsl_tpu_torch.models.resnet3d import BatchNormF32
from test_torch_avhubert import AV, carry, perturb
from test_torch_flamingo_common import ZERO_RATES, one_torch_thread  # noqa: F401

BN_TOL = 1e-5


def _clips(rng, step):
    """[B=2, T=5, 4, 4, C=6] activations; item 1 has 5 - step real frames,
    the rest zeros (padded frames count in the statistics, as in JAX)."""
    x = (2.0 * rng.normal(size=(2, 5, 4, 4, 6)) + 1.0).astype(np.float32)
    x[1, 5 - step:] = 0.0
    return x


def test_torch_batchnorm_training_matches_flax():
    rng = np.random.default_rng(0)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, dtype=jnp.float32)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(_clips(rng, 0)))
    params = {"scale": 1 + 0.2 * rng.normal(size=6).astype(np.float32),
              "bias": 0.3 * rng.normal(size=6).astype(np.float32)}
    stats = {"mean": 0.2 * rng.normal(size=6).astype(np.float32),
             "var": 1 + np.abs(rng.normal(size=6)).astype(np.float32)}
    assert sorted(variables["batch_stats"]) == sorted(stats)
    port = BatchNormF32(6)
    unbiased = {k: torch.from_numpy(v.copy()) for k, v in stats.items()}
    with torch.no_grad():
        for name, value in (("weight", params["scale"]), ("bias", params["bias"]),
                            ("running_mean", stats["mean"]), ("running_var", stats["var"])):
            getattr(port, name).copy_(torch.from_numpy(value))
    for step in range(3):
        x = _clips(rng, step + 1)
        r = rng.normal(size=x.shape).astype(np.float32)

        def f(xx, s=stats):
            y, upd = bn.apply({"params": params, "batch_stats": s}, xx, mutable=["batch_stats"])
            return jnp.sum(y * r), (y, upd["batch_stats"])

        (_, (want, new_stats)), want_dx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
        xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).requires_grad_()  # channels on dim 1
        got = port(xt, use_running_average=False)
        (got * torch.from_numpy(r).permute(0, 4, 1, 2, 3)).sum().backward()
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 4, 1).numpy(), np.asarray(want),
                                   atol=BN_TOL, rtol=0)
        np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want_dx),
                                   atol=BN_TOL, rtol=0)
        stats = jax.tree_util.tree_map(np.asarray, new_stats)
        np.testing.assert_allclose(port.running_mean.numpy(), stats["mean"], atol=BN_TOL, rtol=0)
        np.testing.assert_allclose(port.running_var.numpy(), stats["var"], atol=BN_TOL, rtol=0)
        F.batch_norm(torch.from_numpy(x).permute(0, 4, 1, 2, 3), unbiased["mean"], unbiased["var"],
                     training=True, momentum=0.1)
    # torch's own training update stores the unbiased variance (n / (n - 1))
    assert np.abs(unbiased["var"].numpy() - stats["var"]).max() > 100 * BN_TOL
    # the running statistics are not touched when they are used
    before = port.running_var.clone()
    port(torch.from_numpy(_clips(rng, 0)).permute(0, 4, 1, 2, 3))
    assert torch.equal(port.running_var, before)


def _cfgs(**rates):
    kw = dict(dtype="float32", use_audio=False, modality_fuse="add", **{**ZERO_RATES, **rates})
    return JaxAVHuBERTConfig.tiny_test(**kw), AVHuBERTConfig.tiny_test(**kw)


def _tower(seed=2, **rates):
    jcfg, pcfg = _cfgs(**rates)
    rng = np.random.default_rng(seed)
    video = rng.standard_normal((3, 7, 48, 48, 1)).astype(np.float32)
    jmodel = jax_video_encoder(jcfg)
    variables = perturb(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(video)), rng)
    port = make_av_hubert_video_encoder(pcfg)
    port.load_state_dict(carry({"params": variables["params"]["av_hubert"]["encoder"],
                                "batch_stats": variables["batch_stats"]["av_hubert"]["encoder"]}))
    return jmodel, variables, port, video


@pytest.fixture(scope="module")
def tower():
    return _tower()


def _mask(lengths, t=7):
    return None if lengths is None else np.arange(t)[None, :] < np.asarray(lengths)[:, None]


def _jax_train(jmodel, variables, video, mask, **kw):
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    return jmodel.apply(variables, jnp.asarray(video),
                        mask=None if mask is None else jnp.asarray(mask), deterministic=False,
                        rngs={"dropout": keys[0], "modality": keys[1]}, mutable=["batch_stats"],
                        **kw)


@pytest.mark.parametrize("lengths", [None, [7, 3, 0]], ids=["no_mask", "lengths_7_3_0"])
def test_torch_tower_training_matches_jax(tower, lengths):
    jmodel, variables, base, video = tower
    mask = _mask(lengths)
    rng = np.random.default_rng(9)
    r = rng.normal(size=(3, 7, 32)).astype(np.float32)

    def f(params):
        out, upd = _jax_train(jmodel, {"params": params, "batch_stats": variables["batch_stats"]},
                              video, mask)
        return jnp.sum(out * r), (out, upd["batch_stats"])

    (_, (want, new_stats)), want_grads = jax.value_and_grad(f, has_aux=True)(variables["params"])
    port = copy.deepcopy(base).train()
    got = port(video=torch.from_numpy(video),
               padding_mask=None if mask is None else torch.from_numpy(mask),
               generator=torch.Generator().manual_seed(0))
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
    # running statistics moved, as JAX moved them
    carried = carry({"params": variables["params"]["av_hubert"]["encoder"],
                     "batch_stats": new_stats["av_hubert"]["encoder"]})
    moved = 0.0
    for key, value in port.state_dict().items():
        if "running_" in key:
            np.testing.assert_allclose(value.numpy(), carried[key].numpy(), atol=BN_TOL, rtol=0,
                                       err_msg=key)
            moved = max(moved, (value - base.state_dict()[key]).abs().max().item())
    assert moved > 1e-2
    grads = carry({"params": jax.device_get(want_grads)["av_hubert"]["encoder"]})
    checked = 0
    for name, p in port.named_parameters():
        # mask_emb is read by span masking only; the ResNet: see the docstring
        if name == "mask_emb" or name.startswith("feature_extractor_video.resnet."):
            continue
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=name)
        checked += 1
    assert checked >= 30
    # feature_grad_mult scales the ResNet's gradient and nothing else
    unscaled = copy.deepcopy(base).train()
    unscaled.feature_extractor_video.feature_grad_mult = 1.0
    out = unscaled(video=torch.from_numpy(video),
                   padding_mask=None if mask is None else torch.from_numpy(mask),
                   generator=torch.Generator().manual_seed(0))
    (out * torch.from_numpy(r)).sum().backward()
    for (name, p), q in zip(port.named_parameters(), unscaled.parameters()):
        if name.startswith("feature_extractor_video.resnet."):
            np.testing.assert_allclose(p.grad.numpy(), 0.1 * q.grad.numpy(), rtol=1e-3,
                                       atol=1e-4, err_msg=name)
        elif name != "mask_emb":
            assert torch.equal(p.grad, q.grad), name


def test_torch_tower_unfused_attention_dropout_ignores_key_lengths():
    jmodel, variables, port, video = _tower(attention_dropout=1e-12)
    mask = _mask([7, 3, 0])
    want, _ = _jax_train(jmodel, variables, video, mask, use_running_average=True)
    port.train()
    with torch.no_grad():
        got = port(video=torch.from_numpy(video), padding_mask=torch.from_numpy(mask),
                   use_running_average=True, generator=torch.Generator().manual_seed(0))
        port.eval()
        masked = port(video=torch.from_numpy(video), padding_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    want_masked = jmodel.apply(variables, jnp.asarray(video), mask=jnp.asarray(mask))
    np.testing.assert_allclose(masked.numpy(), np.asarray(want_masked), atol=1e-4)
    # the full-length row agrees with the masked path, the partly padded
    # row does not (the all-padded row's frames are all zero, so its keys
    # are alike and uniform weights come out either way)
    np.testing.assert_allclose(got[[0, 2]].numpy(), masked[[0, 2]].numpy(), atol=1e-4)
    assert (got[1] - masked[1]).abs().max().item() > 1e-3


@pytest.mark.parametrize("audio_dropout", [0.0, 1.0], ids=["video_dropped", "audio_dropped"])
def test_torch_tower_modality_dropout_matches_jax(audio_dropout):
    jmodel, variables, port, video = _tower(modality_dropout=1.0, audio_dropout=audio_dropout)
    want, _ = _jax_train(jmodel, variables, video, None, use_running_average=True)
    port.train()
    with torch.no_grad():
        got = port(video=torch.from_numpy(video), use_running_average=True,
                   generator=torch.Generator().manual_seed(0))
        port.eval()
        kept = port(video=torch.from_numpy(video))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # the video's features are dropped only when the draw picks the video
    assert torch.equal(got, kept) == (audio_dropout == 1.0)
    assert AV == ("video_model", "av_hubert", "encoder")
