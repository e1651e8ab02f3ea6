"""AV-HuBERT fine-tuning of the port against the JAX package (CPU, fp32).

Three steps of the port's ``make_train_step`` over
``avhubert_seq2seq_loss_fn`` or ``avhubert_ctc_loss_fn`` against
``avsl_tpu.train.make_train_step`` over the JAX losses, with the CLI's
optimizer on both sides (global-norm clip 10, then AdamW b1 0.9, b2 0.98,
eps 1e-6, weight decay 0.01 on every parameter, over
``linear_warmup_decay``), on the tiny models carried from JAX with every
rate 0 and BatchNorm on batch statistics. Batches come from the CLI's
``make_synthetic_av_batchset`` and ``collate_av`` with rows cut to
different lengths, so frames are padded.

Loss and grad_norm per step, the step-1 gradients (clipped, read from
Adam's first moments after a step at learning rate 0; ``mask_emb``, which
no loss reaches without a feature mask, is zero on both sides) and the
BatchNorm running statistics after 3 steps agree to atol 1e-5 + rtol
1e-4 (fp32, other summation orders). A gradient element sums over every
frame and position, so its rounding goes with its whole tensor: the
gradients' atol is 1e-4 of their tensor's largest element where that is
more than 1e-5 (the CTC loss sums over frames, so its gradients are tens
of times the token-mean cross-entropy's). The parameters after 3 steps
agree to the same tolerance but for at most 0.1 % of their elements,
which may differ by up to 2 x the summed learning rates: Adam divides
each element's gradient by its own history, so a 1e-9 difference in a
near-zero gradient can become a step of the full learning rate (the rule
of ``tests/test_torch_train.py``). Then ``cli.avhubert_ft --smoke
--device cpu`` for both heads.
"""

import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.train import TrainState as JaxTrainState
from avsl_tpu.train import make_train_step as jax_make_train_step
from avsl_tpu.train.objectives import avhubert_ctc_loss_fn as jax_ctc_loss_fn
from avsl_tpu.train.objectives import avhubert_seq2seq_loss_fn as jax_seq2seq_loss_fn
from avsl_tpu.train.optim import linear_warmup_decay as jax_schedule
from avsl_tpu_torch.cli import avhubert_ft
from avsl_tpu_torch.models import avhubert_state_dict_from_flax
from avsl_tpu_torch.train import TrainState, make_train_step
from avsl_tpu_torch.train.objectives import avhubert_ctc_loss_fn, avhubert_seq2seq_loss_fn
from test_torch_avhubert_models import TOL, carried
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)

LR, STEPS = 1e-3, 20
# the JAX CLI's printed keys (avsl_tpu/cli/avhubert_ft.py:258-282)
JAX_CLI_KEYS = {"head", "steps", "first_loss", "last_loss", "eval_loss"}
JAX_CLI_CTC_KEYS = {"ctc_decoded_lens", "ctc_mean_logprob"}


def cli_batches(head, pad_id, n_steps=3, batch=2):
    """The CLI's synthetic rows (12 frames of 48 x 48, 3-7 labels and EOS),
    cut to 12, 9, 10 or 11 frames, so every row's labels fit in its frames,
    collated two at a time; the CTC view for CTC."""
    rows = avhubert_ft.make_synthetic_av_batchset(n_steps * batch, t=12, image=48, vocab=59,
                                                  seed=3)
    for i, row in enumerate(rows):
        n = (12, 9, 10, 11)[i % 4]
        row["audio_feats"], row["video_feats"] = row["audio_feats"][:n], row["video_feats"][:n]
    out = []
    for i in range(n_steps):
        b = avhubert_ft.collate_av(rows[i * batch:(i + 1) * batch], pad_id)
        out.append(avhubert_ft.ctc_batch(b, pad_id) if head == "ctc" else b)
    return out


def jax_optimizer():
    return optax.chain(optax.clip_by_global_norm(10.0),
                       optax.adamw(jax_schedule(LR, max(STEPS // 10, 1), STEPS),
                                   b1=0.9, b2=0.98, eps=1e-6, weight_decay=0.01))


@pytest.mark.parametrize("head", ["seq2seq", "ctc"])
def test_torch_avhubert_train_steps_match_jax(head):
    jmodel, variables, port, cfg = carried(head, seed=21)
    batches = cli_batches(head, cfg.pad_token_id)
    jloss = (jax_seq2seq_loss_fn if head == "seq2seq" else jax_ctc_loss_fn)(jmodel, train=True)
    tx = jax_optimizer()
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, variables["params"]), tx,
                                  batch_stats=variables["batch_stats"])
    jstep = jax_make_train_step(jloss, tx, donate=False)

    ploss = (avhubert_seq2seq_loss_fn if head == "seq2seq" else avhubert_ctc_loss_fn)(
        port, train=True)
    opt = avhubert_ft.make_optimizer(port, LR, STEPS)
    pstate = TrainState.create(port, opt)
    pstep = make_train_step(ploss)

    lrs = []
    for i, batch in enumerate(batches):
        lrs.append(opt.learning_rate())
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, pm = pstep(pstate, batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), err_msg=f"{key} {i + 1}",
                                       **TOL)
        if i == 0:  # learning rate 0: the first moments hold 0.1 x the clipped gradients
            stats0 = {k: v.clone() for k, v in port.state_dict().items() if "running_" in k}
            want_g = avhubert_state_dict_from_flax(jax.device_get(jstate.opt_state[1][0].mu))
            got_g = dict(zip(opt.names, opt.mu))
            assert sorted(got_g) == sorted(want_g) == sorted(n for n, _ in port.named_parameters())
            for name, w in want_g.items():
                w = w.numpy() / 0.1
                np.testing.assert_allclose(got_g[name].numpy() / 0.1, w, err_msg=name,
                                           atol=max(TOL["atol"], TOL["rtol"] * np.abs(w).max()),
                                           rtol=TOL["rtol"])
            assert all(bool(g.any()) for n, g in got_g.items() if n.split(".")[-1] != "mask_emb")
    assert lrs[0] == 0.0 and lrs[2] > 0.0 and pstate.step == 3 and opt.count == 3
    want_p = avhubert_state_dict_from_flax(jax.device_get(jstate.params),
                                           jax.device_get(jstate.batch_stats))
    got_p = port.state_dict()
    assert sorted(got_p) == sorted(want_p)
    n_out, n_all = 0, 0
    for name, w in want_p.items():
        got, w = got_p[name].numpy(), w.numpy()
        if "running_" in name:  # statistics: no optimizer between them
            np.testing.assert_allclose(got, w, err_msg=name, **TOL)
            assert not np.array_equal(got, stats0[name].numpy()), f"{name} did not train"
            continue
        diff = np.abs(got - w)
        assert diff.max() <= 2 * sum(lrs), (name, diff.max())
        n_out += int((diff > TOL["atol"] + TOL["rtol"] * np.abs(w)).sum())
        n_all += w.size
    assert n_out <= 1e-3 * n_all, (n_out, n_all)


@pytest.mark.parametrize("head", ["seq2seq", "ctc"])
def test_torch_avhubert_ft_cli_smoke_on_cpu(head, capsys):
    """``--smoke --device cpu``: the tiny model with modality dropout 0.2
    and audio dropout 0.5, 6 steps; the JAX CLI's keys, finite losses."""
    out = avhubert_ft.main(["--smoke", "--device", "cpu", "--head", head])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    want = JAX_CLI_KEYS | (JAX_CLI_CTC_KEYS if head == "ctc" else set())
    assert set(out) == want and out["head"] == head and out["steps"] == 6
    assert all(np.isfinite(out[k]) for k in ("first_loss", "last_loss", "eval_loss"))
    if head == "ctc":
        assert len(out["ctc_decoded_lens"]) == 4 and np.isfinite(out["ctc_mean_logprob"])


@pytest.mark.parametrize("flag", [["--n_experts", "2", "--experts_parallel", "2"],
                                  ["--model_parallel", "2"], ["--experts_parallel", "2"]])
def test_torch_avhubert_ft_cli_refuses_the_parallel_layer(flag, tmp_path):
    """On one rank a parallel flag of 2 is refused as JAX refuses it on one
    device, its axis not dividing the devices (the meshes run in
    ``tests/test_torch_avhubert_mesh_cli.py``)."""
    from torch_mesh_workers import one_rank_group

    with one_rank_group(tmp_path), pytest.raises(ValueError, match="not divisible"):
        avhubert_ft.main(["--smoke", "--device", "cpu", *flag])


def test_torch_avhubert_ft_cli_needs_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        avhubert_ft.main(["--smoke"])
