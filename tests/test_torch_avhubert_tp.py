"""The AV-HuBERT fine-tune heads under tensor parallelism (CPU, 2 gloo
ranks at dp 1 x mp 2).

The tiny seq2seq and CTC models with 2 experts of top 2 and an even
vocabulary of 60 (the tiny card's 59 does not divide the model axis, and
``spec_for`` keeps such a leaf whole) train 3 steps with the fine-tune
CLI's optimizer and losses, sequence parallelism on (the step's default
at a model axis above 1) and the tiny card's dropout rates, then take an
eval step. Every rule-split leaf is split: the encoder's and decoder's
attention and MLPs, the MoE hidden dim, the CTC head column-parallel with
its logits gathered, and the decoder's ``embed_tokens`` vocab-parallel
with its tied logits gathered. Losses, the eval loss and every trained
tensor equal one process's within 1e-6 (fp32; losses relative, tensors
absolute), but the attention key biases, whose gradient is zero in exact
arithmetic (Adam turns its rounding noise into steps of the learning
rate), within 3 learning rates.
"""

import numpy as np
import pytest
import torch

from avsl_tpu_torch.cli.avhubert_ft import collate_av, make_synthetic_av_batchset
from avsl_tpu_torch.core.config import AVHuBERTConfig
from avsl_tpu_torch.models import build_avhubert
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)
from torch_mesh_workers import AVH_TP_CFG, avh_tp_ranks, spawn, train_avhubert

TOL = 1e-6
LR = 1e-3  # train_avhubert's peak learning rate


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("avh_tp")
    cfg = AVHuBERTConfig.tiny_test(**AVH_TP_CFG)
    rows = make_synthetic_av_batchset(12, image=24, vocab=cfg.vocab_size, seed=4)
    batches = [collate_av(rows[i:i + 4], cfg.pad_token_id) for i in range(0, 12, 4)]
    paths = {}
    for head in ("seq2seq", "ctc"):
        paths[head] = str(tmp / f"{head}.pt")
        torch.save(build_avhubert(cfg, head, device="cpu", seed=1).state_dict(), paths[head])
    return {"ranks": spawn(avh_tp_ranks, 2, tmp, paths, batches),
            "single": {head: train_avhubert(head, p, batches, None) for head, p in paths.items()}}


@pytest.mark.parametrize("head", ["seq2seq", "ctc"])
def test_torch_avhubert_head_under_tp_matches_one_process(runs, head):
    single = runs["single"][head]
    for rank, out in enumerate(runs["ranks"]):
        got = out[head]
        want_split = ({"decoder.embed_tokens.weight"} if head == "seq2seq"
                      else {"ctc_head.weight", "ctc_head.bias"})
        assert want_split <= set(got["split"]), got["split"]
        assert any(n.endswith("mlp.w_in") for n in got["split"])
        np.testing.assert_allclose(got["loss"], single["loss"], rtol=TOL, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["eval_loss"], single["eval_loss"], rtol=TOL)
        for name, want in single["params"].items():
            # a key bias adds q . b_k to every logit of a query, which the
            # softmax cancels: its gradient is rounding noise, which Adam
            # scales to a step of the learning rate
            atol = 3 * LR if name.endswith("k_proj.bias") else TOL
            np.testing.assert_allclose(got["params"][name], want, atol=atol, rtol=0,
                                       err_msg=f"rank {rank} {name}")
