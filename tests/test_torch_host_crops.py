"""Port of infer/host_crops.py (``HostLipCropper``) against the JAX package.

On the CPU the port's cropper runs the JAX cropper's host code (numpy,
OpenCV, the shared C++ tracker and sampler): landmarks, ok flags and uint8
crops equal exactly, in both modes, both crop contracts, with a custom mean
face (the relayout path) and on a clip with no detection. On the card the
warp samples with ``kernels.warp.sample_separable``; here that sampler, on
the CPU, is held to the host crops within 1 grey level (float32 products
of the same bilinear taps, then truncated).
"""

import numpy as np
import pytest
import torch

from avsl_tpu.infer.host_crops import HostLipCropper as JaxCropper
from avsl_tpu_torch.infer.host_crops import HostLipCropper
from avsl_tpu_torch.kernels.warp import sample_separable
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)
from torch_lip_fixtures import closeup_clips
from torch_native_fixtures import load_jax_native


@pytest.fixture(scope="module", autouse=True)
def steady_jax_natives():
    """JAX's cropper loads the shared tracker and sampler from ``cpp/``."""
    from avsl_tpu.kernels import track_native, warp_native

    load_jax_native(track_native, "avsl_track")
    load_jax_native(warp_native, "avsl_warp")


@pytest.fixture(scope="module")
def clips():
    c = closeup_clips(b=3, t=40)
    c[2] = c[2, :1]  # static: no detection, the canonical fallback
    return c


@pytest.mark.parametrize("mode,emit", [("track", "96"), ("track", "88"), ("interp", "96")])
def test_torch_host_cropper_matches_jax(clips, mode, emit):
    kw = dict(detect_ds=2, track_ds=2, mode=mode, emit=emit)
    want, ok_w = JaxCropper(**kw)(clips)
    cropper = HostLipCropper(device="cpu", **kw)
    got, ok_g = cropper(clips)
    np.testing.assert_array_equal(ok_g, ok_w)
    assert list(ok_g) == [True, True, False]
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    lms, _ = cropper.landmarks(clips)
    np.testing.assert_array_equal(lms, JaxCropper(**kw).landmarks(clips)[0])
    # the card's sampler on the same coordinates, here on the CPU
    ys, xs = cropper.coords(lms)
    dev = sample_separable(torch.from_numpy(clips), torch.from_numpy(ys), torch.from_numpy(xs))
    dev = dev.clamp(0, 255).to(torch.uint8).numpy()
    assert np.abs(dev.astype(int) - got.astype(int)).max() <= 1


def test_torch_host_cropper_custom_mean_face(clips):
    """A mean face of another geometry: interp mode relayouts the motion
    detector's parametric landmarks, track mode synthesizes in it."""
    from avsl_tpu.data.lip_roi import canonical_mean_face

    mf = canonical_mean_face(300).copy()
    mf[48:68, 1] += 4.0
    mf[36:48, 0] *= 1.05
    for mode in ("interp", "track"):
        kw = dict(detect_ds=2, mode=mode, mean_face=mf)
        want, ok_w = JaxCropper(**kw)(clips[:2])
        got, ok_g = HostLipCropper(device="cpu", **kw)(clips[:2])
        np.testing.assert_array_equal(ok_g, ok_w)
        np.testing.assert_array_equal(got, want)


def test_torch_host_cropper_validates():
    with pytest.raises(ValueError):
        HostLipCropper(emit="64", device="cpu")
    with pytest.raises(ValueError):
        HostLipCropper(mode="dlib", device="cpu")
    with pytest.raises(ValueError):
        HostLipCropper(device="cpu")(np.zeros((4, 8, 8), np.uint8))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            HostLipCropper()
