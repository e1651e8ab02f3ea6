"""The port's pretraining entry point and the AV-HuBERT fine-tuning CLI with
experts (CPU).

``cli.pretrain.main(["--smoke", "--device", "cpu"])`` prints the JAX CLI's
result keys (``avsl_tpu/cli/pretrain.py:285-291``) and its loss falls;
with ``--n_experts 4 --iterations 2`` the second iteration trains a fresh
model on k-means of the middle layer's features. Its synthetic rows and
collation are the JAX CLI's, array for array. A ``--km_model`` codebook
written by the JAX package loads in the port (and a fresh fit is written
where the file does not exist); ``--checkpoint_dir`` writes a state whose
encoder the fine-tune heads load; on one rank a parallel flag of 2 is
refused as JAX refuses it on one device (the mesh runs in
``tests/test_torch_pretrain_mesh_cli.py``). ``cli.avhubert_ft --smoke
--n_experts 4 --device cpu`` trains both heads, reporting ``n_experts``
as JAX does.
"""

import json

import numpy as np
import pytest
import torch

from avsl_tpu.cli import pretrain as jax_cli
from avsl_tpu.data.clustering import KMeansQuantizer as JaxQuantizer
from avsl_tpu_torch.cli import avhubert_ft, pretrain
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)

# the JAX CLI's printed keys and those of each iteration
JAX_KEYS = {"steps", "num_clusters", "iterations", "relabel_layer", "first_loss", "last_loss",
            "eval_loss", "eval_acc_masked", "eval_acc_unmasked"}
JAX_ITERATION_KEYS = {"first_loss", "last_loss", "eval_loss", "eval_acc_masked",
                      "eval_acc_unmasked"}


def _check(result, iterations):
    assert set(result) == JAX_KEYS
    assert len(result["iterations"]) == iterations
    for it in result["iterations"]:
        assert set(it) == JAX_ITERATION_KEYS
        assert all(np.isfinite(v) for v in it.values())
        assert it["last_loss"] < it["first_loss"]
    assert result["steps"] == 6 and result["num_clusters"] == 8


def test_torch_pretrain_cli_smoke(capsys):
    result = pretrain.main(["--smoke", "--device", "cpu"])
    _check(result, 1)
    assert result["relabel_layer"] is None
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result


def test_torch_pretrain_cli_moe_two_iterations():
    result = pretrain.main(["--smoke", "--device", "cpu", "--n_experts", "4",
                            "--iterations", "2"])
    _check(result, 2)
    assert result["relabel_layer"] == 1  # tiny_test's 2 layers // 2


def test_torch_pretrain_rows_and_collation_are_jax_cli():
    ours = pretrain.make_synthetic_pretrain_rows(6, feat_dim=104, image=24)
    theirs = jax_cli.make_synthetic_pretrain_rows(6, feat_dim=104, image=24)
    targets = [np.arange(24) % 8 for _ in ours]
    for key in ("audio_feats", "video_feats"):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a[key], b[key])
    ours_b = pretrain.collate_pretrain(ours[:4], targets)
    theirs_b = jax_cli.collate_pretrain(theirs[:4], targets)
    assert sorted(ours_b) == sorted(theirs_b)
    for key in ours_b:
        np.testing.assert_array_equal(ours_b[key], theirs_b[key])


def test_torch_pretrain_cli_km_model_across_packages(tmp_path):
    """A 3-cluster codebook that the JAX package wrote drives the port's
    targets (the result counts its 3 clusters); a missing file gets the
    port's fresh fit, which the JAX package reads."""
    rows = jax_cli.make_synthetic_pretrain_rows(16, feat_dim=104, image=24)
    jax_km = str(tmp_path / "jax_km.npz")
    JaxQuantizer().fit(np.concatenate([r["audio_feats"] for r in rows]), k=3, n_iters=5,
                       seed=0).save(jax_km)
    result = pretrain.main(["--smoke", "--device", "cpu", "--km_model", jax_km])
    assert result["num_clusters"] == 3
    port_km = str(tmp_path / "port_km.npz")
    result = pretrain.main(["--smoke", "--device", "cpu", "--km_model", port_km])
    assert result["num_clusters"] == 8
    assert JaxQuantizer.load(port_km).n_clusters == 8


def test_torch_pretrain_cli_checkpoint_feeds_finetune(tmp_path):
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.models import build_avhubert
    from avsl_tpu_torch.train.checkpoints import partial_load, restore_params_only

    pretrain.main(["--smoke", "--device", "cpu", "--checkpoint_dir", str(tmp_path)])
    saved = restore_params_only(str(tmp_path))
    assert "label_embs_concat" in saved and "encoder.layers.0.fc1.weight" in saved
    cfg = AVHuBERTConfig.tiny_test(dtype="float32")
    ctc = build_avhubert(cfg, "ctc", device="cpu", seed=3)
    _, report = partial_load(ctc, saved)
    assert not report["shape_mismatch"]
    assert sorted(report["unexpected"]) == ["final_proj.bias", "final_proj.weight",
                                            "label_embs_concat"]
    assert all(k.startswith("ctc_head") for k in report["missing"])
    torch.testing.assert_close(ctc.state_dict()["encoder.w2v_model.mask_emb"],
                               saved["mask_emb"], atol=0, rtol=0)


@pytest.mark.parametrize("flag", ["--model_parallel", "--experts_parallel"])
def test_torch_pretrain_cli_parallel_flags_raise(flag, tmp_path):
    """On one rank a flag of 2 is JAX's refusal on one device: the axis
    does not divide it (the meshes themselves run in
    ``tests/test_torch_pretrain_mesh_cli.py``)."""
    from torch_mesh_workers import one_rank_group

    with one_rank_group(tmp_path), pytest.raises(ValueError, match="not divisible"):
        pretrain.main(["--smoke", "--device", "cpu", flag, "2"])


@pytest.mark.parametrize("head", ["seq2seq", "ctc"])
def test_torch_avhubert_ft_cli_moe(head):
    result = avhubert_ft.main(["--smoke", "--n_experts", "4", "--head", head,
                               "--device", "cpu"])
    assert result["n_experts"] == 4 and result["steps"] == 6
    assert all(np.isfinite(result[k]) for k in ("first_loss", "last_loss", "eval_loss"))
    assert result["last_loss"] < result["first_loss"]
