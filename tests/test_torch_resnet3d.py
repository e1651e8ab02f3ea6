"""Port ResNet-3D lip frontend against the JAX one on carried weights (CPU, fp32).

The JAX ``ResNet3DFrontend`` (tiny widths: 8 stem channels, a 64-wide
trunk) is initialised, every param gets seeded noise and every BatchNorm
running statistic is perturbed (mean noise, var = 1 + |noise|) so the
inference BatchNorm is not the identity; the same numbers go to the port
through its weight carrier. Features agree to atol 1e-4: fp32 on both
sides, convolutions summed in other orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.models.resnet3d import ResNet3DFrontend as JaxFrontend
from avsl_tpu_torch.models import ResNet3DFrontend, state_dict_from_flax
from avsl_tpu_torch.models.convert import flax_path_to_torch_key

PREFIX = "video_model.feature_extractor_video.resnet."


def perturb(variables, rng):
    """Noise on every param; BatchNorm means shifted, variances 1 + |noise|."""
    noisy = lambda x, s: np.asarray(x) + s * rng.standard_normal(np.shape(x)).astype(np.float32)  # noqa: E731
    out = {"params": jax.tree_util.tree_map(lambda x: noisy(x, 0.05), variables["params"])}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, x: (np.asarray(x) + np.abs(0.5 * rng.standard_normal(np.shape(x))).astype(np.float32)
                             if path[-1].key == "var" else noisy(x, 0.2)),
            variables["batch_stats"])
    return out


def carry_frontend(variables):
    """The JAX frontend's variables -> a port ResNet3DFrontend state dict."""
    nest = lambda tree: {"video_model": {"av_hubert": {"encoder": {"visual_encoder": {"frontend": tree}}}}}  # noqa: E731
    sd = state_dict_from_flax(nest(variables["params"]), nest(variables["batch_stats"]))
    return {k[len(PREFIX):]: v for k, v in sd.items()}


@pytest.fixture(scope="module")
def carried():
    jmodel = JaxFrontend(frontend_channels=8, backbone_channels=64, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    init = jmodel.init(jax.random.PRNGKey(0), np.zeros((1, 5, 40, 40, 1), np.float32), True)
    variables = perturb(init, rng)
    port = ResNet3DFrontend(8, 64, dtype=torch.float32)
    port.load_state_dict(carry_frontend(variables))
    return jmodel, variables, init, port.eval()


@pytest.mark.parametrize("ndim", [4, 5])
def test_torch_resnet3d_matches_jax(carried, ndim):
    jmodel, variables, _, port = carried
    rng = np.random.default_rng(ndim)
    video = rng.standard_normal((2, 7, 40, 36, 1)).astype(np.float32)  # odd T, non-square
    if ndim == 4:
        video = video[..., 0]
    want = np.asarray(jmodel.apply(variables, jnp.asarray(video), True))
    with torch.inference_mode():
        got = port(torch.from_numpy(video)).numpy()
    assert got.shape == want.shape == (2, 7, 64)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_torch_resnet3d_batch_stats_matter(carried):
    """Not vacuous: the carried BatchNorm statistics change the features."""
    jmodel, variables, init, port = carried
    video = np.random.default_rng(9).standard_normal((1, 5, 40, 40)).astype(np.float32)
    identity_stats = {"params": variables["params"], "batch_stats": init["batch_stats"]}
    with torch.inference_mode():
        got = port(torch.from_numpy(video)).numpy()
    other = np.asarray(jmodel.apply(identity_stats, jnp.asarray(video), True))
    assert np.abs(got - other).max() > 1e-2


def test_torch_resnet3d_stem_is_the_conv3d(carried):
    """The 2-D stem over five stacked time taps equals the Conv3D it
    replaces (k=(5,7,7), stride (1,2,2), padding (2,3,3))."""
    _, _, _, port = carried
    video = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 6, 30, 30)).astype(np.float32))
    conv = port.frontend3D[0]
    want = conv(video[:, None])  # [B, C, T, H', W']
    got = port.stem(video)  # [B*T, C, H', W']
    want = want.permute(0, 2, 1, 3, 4).reshape(got.shape)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_torch_resnet3d_schema_matches_jax():
    """Every variable of the AV-HuBERT-large frontend (64-channel stem,
    512-wide trunk) maps to a port state-dict entry of the carried shape,
    and nothing is left over."""
    tree = jax.eval_shape(lambda key, video: JaxFrontend().init(key, video, True),
                          jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 5, 88, 88, 1), jnp.float32))
    port = ResNet3DFrontend(64, 512, device="meta")
    ours = {k: tuple(t.shape) for k, t in port.state_dict().items()}
    theirs = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree[collection])[0]:
            flax_path = "/".join(str(p.key) for p in path)
            key = flax_path_to_torch_key(
                "video_model/av_hubert/encoder/visual_encoder/frontend/" + flax_path)
            shape = leaf.shape
            if flax_path.endswith("kernel"):  # [..., in, out] -> [out, in, ...]
                shape = (shape[-1], shape[-2], *shape[:-2])
            theirs[key[len(PREFIX):]] = tuple(shape)
    assert ours == theirs
    assert ours["frontend3D.0.weight"] == (64, 1, 5, 7, 7)
