"""The port's CNN landmark regressor against the JAX package's.

The weights carry both ways between flax's param tree and the port's
state dict; the shipped asset is a byte-identical copy; on it the port's
predictions over JAX's held-out synthetic faces (seed 20260820, 128 x 128)
sit within 1e-4 px of JAX's (fp32 convolutions summed in other orders).
A hand-built check shows that the two layout traps, symmetric padding in
place of flax's 'SAME' (0 before, 1 after at stride 2) and a CHW flatten
in place of flax's HWC, each move the output far outside that tolerance.
JAX's four accuracy cases against exact synthetic truth
(``tests/test_landmark_synthetic_truth.py``) run on the port; the ``.npz``
each package writes is one the other loads; ``create_detector("cnn")``
builds the detector; a 128 x 128 frame skips OpenCV's resize, which would
be the identity.
"""

import hashlib
import os
import sys

import cv2
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from avsl_tpu.data import landmarks as jax_lm
from avsl_tpu.data.synthetic_faces import generate_dataset
from avsl_tpu_torch.data import landmarks as port_lm
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)

HELD_OUT_SEED = 20260820
PX_TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_init(seed=0):
    return jax_lm.landmark_net().init(jax.random.PRNGKey(seed),
                                      jnp.zeros((1, 128, 128, 1), jnp.float32))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def faces(n=48, seed=HELD_OUT_SEED):
    imgs, lms = generate_dataset(n, seed=seed)
    return imgs.astype(np.uint8), lms


@pytest.fixture(scope="module")
def held_out():
    """(images, labels, JAX pixel predictions, port pixel predictions) on
    the shipped weights."""
    imgs, lms = faces()
    want = np.stack(jax_lm.CNNLandmarkDetector()(imgs))
    got = np.stack(port_lm.CNNLandmarkDetector(device="cpu")(imgs))
    return imgs, lms, want, got


def test_torch_cnn_carrier_round_trips():
    params = to_numpy(jax_init(3))
    sd = port_lm.cnn_state_dict_from_flax(params)
    assert set(sd) == set(port_lm.landmark_net("cpu").state_dict())
    back = port_lm.cnn_state_dict_to_flax(sd)
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_want) == len(flat_got) == 14
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], leaf)
    # and from the port's side: its own random weights through flax and back
    net = port_lm.landmark_net("cpu", seed=5)
    again = port_lm.cnn_state_dict_from_flax(port_lm.cnn_state_dict_to_flax(net.state_dict()))
    for k, v in net.state_dict().items():
        torch.testing.assert_close(again[k], v, atol=0, rtol=0)


def test_torch_cnn_forward_matches_jax_and_layout_traps_do_not():
    """Random carried weights and a seeded input: the port within 1e-5 of
    flax; a symmetric pad or a CHW flatten of the same weights is off by
    far more."""
    params = to_numpy(jax_init(1))
    x = np.random.default_rng(0).random((3, 128, 128, 1), dtype=np.float32)
    want = np.asarray(jax_lm.landmark_net().apply(params, x))
    net = port_lm.landmark_net("cpu")
    net.load_state_dict(port_lm.cnn_state_dict_from_flax(params))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    def variant(symmetric: bool, chw: bool):
        h = torch.from_numpy(x).permute(0, 3, 1, 2)
        with torch.no_grad():
            for conv in net.convs:
                h = F.relu(conv(F.pad(h, (1, 1, 1, 1) if symmetric else (0, 1, 0, 1))))
            h = (h if chw else h.permute(0, 2, 3, 1)).reshape(h.shape[0], -1)
            return torch.sigmoid(net.dense_1(F.relu(net.dense_0(h)))).reshape(-1, 68, 2).numpy()

    np.testing.assert_allclose(variant(False, False), want, atol=1e-5, rtol=0)
    for symmetric, chw in ((True, False), (False, True)):
        assert np.abs(variant(symmetric, chw) - want).max() > 100 * 1e-5, (symmetric, chw)


def test_torch_cnn_matches_jax_on_shipped_weights(held_out):
    _, _, want, got = held_out
    assert got.shape == want.shape == (48, 68, 2)
    np.testing.assert_allclose(got, want, atol=PX_TOL, rtol=0)


@pytest.fixture(scope="module")
def errors(held_out):
    _, lms, _, got = held_out
    return np.linalg.norm(got - lms * 128, axis=-1)  # [N, 68]


def test_torch_mouth_landmark_error_below_threshold(errors):
    assert errors[:, 48:68].mean() < 8.0


def test_torch_all_landmark_error_below_threshold(errors):
    assert errors.mean() < 11.0


def test_torch_no_catastrophic_faces(errors):
    assert errors[:, 48:68].mean(axis=1).max() < 35.0


def test_torch_beats_static_center_baseline(errors, held_out):
    from avsl_tpu_torch.data.lip_roi import canonical_mean_face

    _, lms, _, _ = held_out
    canon = canonical_mean_face(300)
    static = (canon - canon.mean(0)) * (128 / 300.0) + 128 / 2.0
    base = np.linalg.norm(static[None] - lms * 128, axis=-1).mean()
    assert errors.mean() < 0.5 * base


def test_torch_cnn_npz_interchange(tmp_path):
    """JAX loads the port's file and the port loads JAX's: the same
    weights either way, and JAX's detector on the port's file predicts
    what the port's does."""
    jax_path = str(tmp_path / "jax.npz")
    params = to_numpy(jax_init(2))
    jax_lm.save_cnn_params(params, jax_path)
    loaded = port_lm.load_cnn_params(jax_path)
    for k, v in port_lm.cnn_state_dict_from_flax(params).items():
        torch.testing.assert_close(loaded[k], v, atol=0, rtol=0)

    port_path = str(tmp_path / "port.npz")
    net = port_lm.landmark_net("cpu", seed=4)
    port_lm.save_cnn_params(net.state_dict(), port_path)
    with np.load(port_path) as z:
        assert sorted(z.files) == sorted(
            f"params/{layer}/{leaf}" for layer in
            [f"Conv_{i}" for i in range(5)] + ["Dense_0", "Dense_1"]
            for leaf in ("kernel", "bias"))
    imgs, _ = faces(4, seed=9)
    want = np.stack(jax_lm.CNNLandmarkDetector(params=jax_lm.load_cnn_params(port_path))(imgs))
    got = np.stack(port_lm.CNNLandmarkDetector(weights_path=port_path, device="cpu")(imgs))
    np.testing.assert_allclose(got, want, atol=PX_TOL, rtol=0)


def test_torch_cnn_asset_is_a_byte_identical_copy():
    def digest(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    assert port_lm.DEFAULT_CNN_WEIGHTS == os.path.join(
        REPO, "avsl_tpu_torch", "data", "assets", "landmark_cnn.npz")
    assert digest(port_lm.DEFAULT_CNN_WEIGHTS) == digest(jax_lm.DEFAULT_CNN_WEIGHTS)


def test_torch_create_detector_cnn():
    det = port_lm.create_detector("cnn", device="cpu")
    assert isinstance(det, port_lm.CNNLandmarkDetector)
    imgs, _ = faces(2, seed=11)
    out = det(imgs)
    assert len(out) == 2 and all(o.shape == (68, 2) and np.isfinite(o).all() for o in out)


def test_torch_cnn_resize_is_identity_at_128_and_runs_elsewhere(monkeypatch):
    """OpenCV's resize of a 128 x 128 frame to 128 x 128 is the identity,
    so the port skips it (it never imports cv2 then); another size is
    resized as JAX resizes it, and the pixels scale to that frame."""
    imgs, _ = faces(3, seed=12)
    for f in imgs:
        np.testing.assert_array_equal(cv2.resize(f, (128, 128)), f)
    det = port_lm.CNNLandmarkDetector(device="cpu")
    monkeypatch.setitem(sys.modules, "cv2", None)  # an import of cv2 would fail
    no_cv2 = np.stack(det(imgs))
    monkeypatch.undo()
    np.testing.assert_allclose(no_cv2, np.stack(jax_lm.CNNLandmarkDetector()(imgs)),
                               atol=PX_TOL, rtol=0)
    small = np.stack([cv2.resize(f, (96, 80)) for f in imgs])  # [3, 80, 96]
    np.testing.assert_allclose(np.stack(det(small)),
                               np.stack(jax_lm.CNNLandmarkDetector()(small)), atol=PX_TOL, rtol=0)
