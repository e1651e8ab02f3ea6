"""The port's landmark-CNN trainer against the JAX package's.

* ``warmup_cosine_decay`` against optax's ``warmup_cosine_decay_schedule``
  at counts 0-150 of a 120-step run (fp32; the cosine may differ in its
  last bits, rtol 1e-6), and its refusal of a decay no longer than the
  warmup, which is optax's: both CLIs refuse ``--steps`` of 100 or fewer.
* The loop from JAX's ``net.init(PRNGKey(0))`` carried across, against
  JAX's ``main`` on the same flags (the same seeded batches, loss,
  optimizer and schedule) over 101 steps, the fewest JAX's main takes.
  Adam turns gradients near zero into steps of about the learning rate
  whatever their rounding, and an L1 loss flips with the sign of each
  residual, so two fp32 runs drift apart: JAX against itself with its
  init perturbed by 1e-7 (relative) ends 0.05 apart in the weights at the
  default lr 1e-3 (measured on a CPU). At lr 1e-5 the drift stays
  small, and the run is held to: the final loss within rtol 1e-4, the
  validation pixel errors within 1e-3 px, every weight within 1e-4 (a
  weight moves up to 8e-4 in the run) and 95 % of them within 1e-6.
* ``main`` end to end with ``--device cpu``: the flax-layout ``.npz`` that
  JAX's detector loads and predicts from as the port's does.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.cli import train_landmarks as jax_cli
from avsl_tpu.data import landmarks as jax_lm
from avsl_tpu_torch.cli import train_landmarks as port_cli
from avsl_tpu_torch.data import landmarks as port_lm
from avsl_tpu_torch.data.synthetic_faces import generate_dataset
from avsl_tpu_torch.train.optim import warmup_cosine_decay
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)

FLAGS = ["--steps", "101", "--batch_size", "8", "--n_train", "64", "--n_val", "16",
         "--lr", "1e-5", "--seed", "0"]


def test_torch_warmup_cosine_decay_matches_optax():
    want = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 100, 120)
    got = warmup_cosine_decay(0.0, 1e-3, 100, 120)
    w = np.array([float(want(c)) for c in range(151)])
    g = np.array([got(c) for c in range(151)])
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
    assert g[0] == 0.0 and g[100] == np.float32(1e-3) and (g[120:] == 0.0).all()
    # a non-zero start
    want = optax.warmup_cosine_decay_schedule(1e-4, 2e-3, 10, 50)
    got = warmup_cosine_decay(1e-4, 2e-3, 10, 50)
    np.testing.assert_allclose([got(c) for c in range(60)], [float(want(c)) for c in range(60)],
                               rtol=1e-6, atol=0)


def test_torch_train_landmarks_refuses_short_runs_as_jax_does(tmp_path):
    args = ["--steps", "10", "--n_train", "8", "--n_val", "4", "--out", str(tmp_path / "w.npz")]
    with pytest.raises(ValueError):
        jax_cli.main(args)
    with pytest.raises(ValueError):
        port_cli.main(args + ["--device", "cpu"])
    with pytest.raises(ValueError):
        warmup_cosine_decay(0.0, 1e-3, 100, 100)


def test_torch_train_loop_matches_jax_main(tmp_path):
    jax_path = str(tmp_path / "jax.npz")
    want = jax_cli.main(FLAGS + ["--out", jax_path])
    init = jax_lm.landmark_net().init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 1)))
    imgs, lms = generate_dataset(64, seed=0)
    val_imgs, val_lms = generate_dataset(16, seed=1)
    net, got = port_cli.train(port_lm.cnn_state_dict_from_flax(init), imgs, lms, val_imgs,
                              val_lms, steps=101, batch_size=8, lr=1e-5, seed=0, device="cpu")
    assert got["steps"] == want["steps"] == 101 and len(got["losses"]) == 101
    assert np.isfinite(got["losses"]).all()
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=1e-4)
    for key in ("val_px_error", "val_mouth_px_error"):
        assert abs(got[key] - want[key]) < 1e-3, (key, got[key], want[key])
    trained = port_lm.load_cnn_params(jax_path)
    start = port_lm.cnn_state_dict_from_flax(init)
    diff = np.concatenate([(v - trained[k]).abs().flatten().numpy()
                           for k, v in net.state_dict().items()])
    moved = np.concatenate([(trained[k] - start[k]).abs().flatten().numpy() for k in start])
    assert diff.max() < 1e-4, diff.max()
    assert (diff <= 1e-6).mean() > 0.95, (diff <= 1e-6).mean()
    assert moved.max() > 4e-4  # the weights moved well past the tolerance


def test_torch_train_landmarks_cli_writes_what_jax_loads(tmp_path, capsys):
    out = str(tmp_path / "sub" / "cnn.npz")
    result = port_cli.main(["--steps", "101", "--batch_size", "4", "--n_train", "16",
                            "--n_val", "8", "--out", out, "--device", "cpu"])
    assert "saved" in capsys.readouterr().out
    assert result["steps"] == 101 and np.isfinite(result["final_loss"])
    assert np.isfinite([result["val_px_error"], result["val_mouth_px_error"]]).all()
    imgs = generate_dataset(3, seed=5)[0].astype(np.uint8)
    want = np.stack(jax_lm.CNNLandmarkDetector(params=jax_lm.load_cnn_params(out))(imgs))
    got = np.stack(port_lm.CNNLandmarkDetector(weights_path=out, device="cpu")(imgs))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert not torch.equal(port_lm.load_cnn_params(out)["convs.0.weight"],
                           port_lm.landmark_net("cpu").state_dict()["convs.0.weight"])
