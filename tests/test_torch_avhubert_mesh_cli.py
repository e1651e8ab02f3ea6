"""The AV-HuBERT fine-tuning CLI on its mesh flags (CPU, ``python -m
torch.distributed.run`` over 2 gloo ranks); the pretraining CLI's are in
``tests/test_torch_pretrain_mesh_cli.py``, with these helpers.

The JAX CLI's own cases (``tests/test_moe.py:207`` and ``:220``:
``avhubert_ft --smoke --n_experts 4 --experts_parallel 2`` and ``--head
ctc --n_experts 2 --model_parallel 2``). Each runs as one process a rank; rank 0 alone
prints, once. Held against JAX's ``main``: ``mesh`` is the shape JAX's
rule gives at the port's world size (``{"data": 1, "expert": 2}``, or
``"model"``), and ``sharded_params`` is what JAX's ``main`` reports, the
count of ``describe_shardings`` over the same model's parameters on the
mesh it builds (computed here from JAX's own initialisation on its
8-device mesh, without the 25-110 s of JAX's training run a CPU core
spends; the count does not depend on the data axis; JAX's ``main``,
run in full outside the suite, reports 8 and 20 for these two cases, 8
and 23 for the pretraining ones). The losses (fp32)
equal the port's one-process run of the same flags within 1e-5 relative:
the packages' random draws differ, so their losses do not, while the
mesh reproduces one device's; and the expert-parallel fine-tune's loss
falls, as JAX's test asserts.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from avsl_tpu.core.config import AVHuBERTConfig as JaxAVHuBERTConfig
from avsl_tpu.core.mesh import make_mesh as jax_make_mesh
from avsl_tpu.core.partitioning import describe_shardings as jax_describe_shardings
from avsl_tpu.models.moe import make_ep_mesh as jax_make_ep_mesh
from avsl_tpu_torch.cli import avhubert_ft, pretrain
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
CASES = {
    "ft_ep": ("avhubert_ft", ["--n_experts", "4", "--experts_parallel", "2"]),
    "ft_ctc_tp": ("avhubert_ft", ["--head", "ctc", "--n_experts", "2", "--model_parallel", "2"]),
}


def _flag(flags, name, default):
    return int(flags[flags.index(name) + 1]) if name in flags else default


def jax_cli_sharding(cli, flags):
    """JAX ``main``'s ``mesh`` and ``sharded_params`` for ``flags`` with
    ``--smoke`` (``avhubert_ft.py:212-236``, ``pretrain.py:182-224``): the
    smoke model initialised as ``main`` initialises it (shapes only), on
    the mesh ``main`` builds over JAX's 8 devices."""
    from avsl_tpu.cli import avhubert_ft as jax_ft
    from avsl_tpu.cli import pretrain as jax_pre
    from avsl_tpu.models.avhubert import AVHuBERTForCTC, AVHuBERTForSpeech2Text
    from avsl_tpu.models.pretrain import AVHuBERTForPretraining

    n_experts = _flag(flags, "--n_experts", 0)
    ep, mp = _flag(flags, "--experts_parallel", 1), _flag(flags, "--model_parallel", 1)
    base = dict(dtype="float32", modality_dropout=0.2, audio_dropout=0.5, n_experts=n_experts)
    keys = {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}
    if cli == "avhubert_ft":
        cfg = JaxAVHuBERTConfig.tiny_test(**base)
        probe = jax_ft.collate_av(jax_ft.make_synthetic_av_batchset(4, image=24,
                                                                    vocab=cfg.vocab_size),
                                  cfg.pad_token_id)
        if "ctc" in flags:
            model, kw = AVHuBERTForCTC(cfg), {}
        else:
            model, kw = AVHuBERTForSpeech2Text(cfg), {"labels": probe["labels"]}
    else:
        cfg = JaxAVHuBERTConfig.tiny_test(mask_prob_audio=0.5, mask_length_audio=4, **base)
        rows = jax_pre.make_synthetic_pretrain_rows(4, image=24)
        probe = jax_pre.collate_pretrain(rows, [np.zeros(24, np.int32)] * 4)
        model = AVHuBERTForPretraining(cfg, num_classes=(8,))  # --smoke: 8 clusters
        kw = {"targets": probe["targets"], "deterministic": True}
    shapes = jax.eval_shape(lambda: model.init(
        keys, audio=probe["audio"], video=probe["video"], padding_mask=probe["padding_mask"],
        **kw))
    mesh = (jax_make_ep_mesh(8, experts_parallel=ep) if ep > 1
            else jax_make_mesh(8, model_parallel=mp))
    return dict(mesh.shape), len(jax_describe_shardings(shapes["params"], mesh))


def _launch(tmp_path, cli, flags):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", f"avsl_tpu_torch.cli.{cli}", "--smoke", "--device", "cpu", *flags],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    printed = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert len(printed) == 1, proc.stdout[-3000:]  # rank 0 alone prints
    return printed[0]


def check_cli_on_mesh(tmp_path, case, cli, flags):
    """One case: the launcher's result against JAX and one process."""
    got = _launch(tmp_path, cli, flags)
    jax_mesh, jax_sharded = jax_cli_sharding(cli, flags)
    axis = "expert" if "--experts_parallel" in flags else "model"
    assert jax_mesh == {"data": 4, axis: 2}  # JAX's rule over its 8 devices
    assert got["mesh"] == {"data": 1, axis: 2}  # the same rule over the port's 2 ranks
    assert got["sharded_params"] == jax_sharded > 0
    module = avhubert_ft if cli == "avhubert_ft" else pretrain
    flags_alone = [f for i, f in enumerate(flags)
                   if f not in ("--experts_parallel", "--model_parallel")
                   and flags[i - 1] not in ("--experts_parallel", "--model_parallel")]
    alone = module.main(["--smoke", "--device", "cpu", *flags_alone])
    assert set(got) - set(alone) == {"mesh", "sharded_params"}
    for key in ("first_loss", "last_loss", "eval_loss"):
        np.testing.assert_allclose(got[key], alone[key], rtol=LOSS_RTOL, err_msg=key)
    if cli == "pretrain":
        for key in ("eval_acc_masked", "eval_acc_unmasked"):
            np.testing.assert_allclose(got[key], alone[key], rtol=LOSS_RTOL, err_msg=key)
        assert len(got["iterations"]) == len(alone["iterations"])
        for it_got, it_alone in zip(got["iterations"], alone["iterations"]):
            for key, value in it_alone.items():
                np.testing.assert_allclose(it_got[key], value, rtol=LOSS_RTOL, err_msg=key)
    if case == "ft_ep":  # tests/test_moe.py:207
        assert got["n_experts"] == 4 and got["last_loss"] < got["first_loss"]
    if case == "ft_ctc_tp":
        assert got["ctc_decoded_lens"] == alone["ctc_decoded_lens"]


@pytest.mark.parametrize("case", list(CASES))
def test_torch_cli_mesh_flags_match_jax_and_one_process(tmp_path, case):
    check_cli_on_mesh(tmp_path, case, *CASES[case])
