"""The port's synthetic-face generator against the JAX package's: the
rendered faces and their exact labels bit for bit for two seeds (numpy on
both sides, the port's own canonical layout), and the pseudo-labeled real
footage (the refined tracker on a rendered talking-face clip written as
an mp4, then seeded crops, resizes and jitter) bit for bit too."""

import numpy as np
import pytest

from avsl_tpu.data import synthetic_faces as jax_faces
from avsl_tpu.data.video_io import write_video_frames
from avsl_tpu_torch.data import synthetic_faces as port_faces
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)
from torch_lip_fixtures import face_clip


@pytest.mark.parametrize("seed,size", [(0, 128), (20260820, 96)])
def test_torch_generate_dataset_bit_equal(seed, size):
    want = jax_faces.generate_dataset(6, size=size, seed=seed)
    got = port_faces.generate_dataset(6, size=size, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (6, size, size) and got[1].shape == (6, 68, 2)
    assert 0.0 <= got[0].min() and got[0].max() <= 255.0


def test_torch_render_face_consumes_the_same_draws():
    """One face from each generator leaves both at the same state."""
    rj, rp = np.random.default_rng(3), np.random.default_rng(3)
    for g, w in zip(port_faces.render_face(rp), jax_faces.render_face(rj)):
        np.testing.assert_array_equal(g, w)
    assert rp.random() == rj.random()


def test_torch_pseudo_label_dataset_matches_jax(tmp_path):
    frames, _ = face_clip(t=12)
    path = write_video_frames(str(tmp_path / "face.mp4"), frames, fps=25)
    want = jax_faces.pseudo_label_dataset([path], per_frame=3, seed=2)
    got = port_faces.pseudo_label_dataset([path], per_frame=3, seed=2)
    assert len(want[0]) > 0  # the tracker found the rendered face
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[0].shape[1:] == (128, 128) and got[1].shape[1:] == (68, 2)
