"""The losses with an MoE trunk, the port against the JAX package (CPU).

The Flamingo loss collecting the Switch balance loss from a tiny MoE video
trunk (``tests/test_moe.py:148-205``): the loss (CE + 0.01 aux) rtol 2e-5
and ``moe_aux`` atol 1e-5 + rtol 1e-4 against JAX, every router with a
gradient; a dense trunk and the hoisted loss report none. The AV-HuBERT
seq2seq and CTC losses with 4 experts of top 2 in every encoder block
(weights carried through ``convert.py``'s MoE leaves): in training CE (or
CTC) + 0.01 aux, in eval the CE alone, each with ``moe_aux`` as JAX's;
and the CLI's CTC closure, which adds the aux in eval too.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.train.objectives import avhubert_ctc_loss_fn as jax_ctc_loss_fn
from avsl_tpu.train.objectives import avhubert_seq2seq_loss_fn as jax_seq2seq_loss_fn
from avsl_tpu.train.objectives import flamingo_loss_fn as jax_flamingo_loss_fn
from avsl_tpu_torch.train.objectives import (
    avhubert_ctc_loss_fn,
    avhubert_seq2seq_loss_fn,
    flamingo_loss_fn,
)
from test_torch_avhubert_models import av_inputs, carried, close
from test_torch_flamingo_common import carried_flamingo, one_torch_thread  # noqa: F401


def _flamingo_batch(cfg, rng):
    dec = rng.integers(0, 200, (2, 5))
    return {"input_ids": rng.normal(size=(2, cfg.n_mels, 64)).astype(np.float32),
            "dec_input_ids": dec,
            "labels": np.concatenate([dec[:, 1:], np.full((2, 1), 3)], axis=1),
            "video": rng.normal(size=(2, 6, 48, 48, 1)).astype(np.float32)}


@pytest.mark.parametrize("n_experts", [2, 0], ids=["moe", "dense"])
def test_torch_flamingo_loss_collects_moe_aux(n_experts):
    """``tests/test_moe.py:148-205`` against JAX: a MoE video trunk's
    balance loss joins the training loss (0.01 x aux) and is reported; a
    dense trunk reports none; the hoisted loss skips it."""
    jmodel, variables, port, cfg = carried_flamingo(seed=2, n_experts=n_experts)
    batch = _flamingo_batch(cfg, np.random.default_rng(0))
    want, (want_m, _) = jax.jit(jax_flamingo_loss_fn(jmodel, train=True))(
        variables["params"], variables["batch_stats"],
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    port = copy.deepcopy(port)
    loss, metrics = flamingo_loss_fn(port, train=True)(
        {k: torch.as_tensor(v) for k, v in batch.items()}, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), float(want), rtol=2e-5)
    assert sorted(metrics) == sorted(want_m)
    if n_experts:
        close(metrics["moe_aux"], want_m["moe_aux"])
        assert float(metrics["moe_aux"]) > 0.5
        loss.backward()
        routers = [p for n, p in port.named_parameters() if n.endswith("mlp.router")]
        assert len(routers) == 2 and all(float(r.grad.abs().max()) > 0 for r in routers)
        # the hoisted loss runs no tower and adds no aux
        port.zero_grad()
        with torch.no_grad():
            enc, v = port.encode_towers(torch.as_tensor(batch["input_ids"]),
                                        video=torch.as_tensor(batch["video"]))
        _, hoisted = flamingo_loss_fn(port, train=True)(
            {"dec_input_ids": torch.as_tensor(batch["dec_input_ids"]),
             "labels": torch.as_tensor(batch["labels"]), "enc_features": enc,
             "video_feats": v}, torch.Generator().manual_seed(0))
        assert hoisted == {}


@pytest.fixture(scope="module", params=["seq2seq", "ctc"])
def moe_head(request):
    return request.param, carried(request.param, seed=4, n_experts=4, moe_top_k=2)


def _head_batch(head, pad):
    audio, video, padding, dec = av_inputs(11)
    batch = {"audio": audio, "video": video, "padding_mask": padding}
    if head == "seq2seq":
        batch["dec_input_ids"] = dec
        batch["labels"] = np.where(dec == 1, -100, np.roll(dec, -1, axis=1))
    else:
        batch["labels"] = np.array([[5, 6, 7, 1], [8, 9, 1, 1], [10, 1, 1, 1]])
        batch["label_padding"] = (batch["labels"] == pad).astype(np.float32)
        batch["logit_padding"] = 1.0 - padding.astype(np.float32)
    return batch


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_torch_avhubert_moe_losses_match_jax(moe_head, train):
    """With 4 experts of top 2 in every encoder block (weights carried
    through ``convert.py``'s MoE leaves): the loss (CE or CTC, + 0.01 aux
    in training only) and ``moe_aux`` as JAX's."""
    head, (jmodel, variables, port, pcfg) = moe_head
    assert {n.split(".")[-1] for n, _ in port.named_parameters() if ".mlp." in n} == {
        "router", "w_in", "b_in", "w_out", "b_out"}
    batch = _head_batch(head, pcfg.pad_token_id)
    jloss = (jax_seq2seq_loss_fn if head == "seq2seq" else jax_ctc_loss_fn)(jmodel, train=train)
    want, (want_m, _) = jax.jit(jloss)(variables["params"], variables["batch_stats"],
                                       {k: jnp.asarray(v) for k, v in batch.items()},
                                       jax.random.PRNGKey(0))
    port = copy.deepcopy(port)
    loss_fn = (avhubert_seq2seq_loss_fn if head == "seq2seq" else avhubert_ctc_loss_fn)(
        port, train=train)
    with torch.set_grad_enabled(train):
        loss, metrics = loss_fn({k: torch.as_tensor(v) for k, v in batch.items()},
                                torch.Generator().manual_seed(0))
    close(metrics["moe_aux"], want_m["moe_aux"])
    close(loss, want)
    plain = (avhubert_seq2seq_loss_fn if head == "seq2seq" else avhubert_ctc_loss_fn)(
        copy.deepcopy(port), train=train, moe_aux_coef=0.0)
    with torch.no_grad():
        ce, _ = plain({k: torch.as_tensor(v) for k, v in batch.items()},
                      torch.Generator().manual_seed(0))
    expected = float(ce) + (0.01 * float(metrics["moe_aux"]) if train else 0.0)
    assert float(loss) == pytest.approx(expected, rel=1e-5)


def test_torch_cli_ctc_closure_adds_aux_in_eval_too():
    """The JAX CLI's CTC closure adds 0.01 x aux whatever its train flag;
    the objective's eval loss is the CTC loss alone."""
    from avsl_tpu_torch.cli.avhubert_ft import cli_ctc_loss_fn
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.models import build_avhubert

    cfg = AVHuBERTConfig.tiny_test(dtype="float32", n_experts=4)
    port = build_avhubert(cfg, "ctc", device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _head_batch("ctc", cfg.pad_token_id).items()}
    with torch.no_grad():
        cli, _ = cli_ctc_loss_fn(port, train=False)(batch, None)
        obj, metrics = avhubert_ctc_loss_fn(port, train=False)(batch, None)
    assert float(metrics["moe_aux"]) > 0
    assert float(cli) == pytest.approx(float(obj) + 0.01 * float(metrics["moe_aux"]), rel=1e-6)
