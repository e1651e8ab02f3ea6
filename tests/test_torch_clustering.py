"""k-means targets of the port (``data/clustering.py``) with its MFCC
features (``kernels/fbank.py``), against the JAX package (CPU).

The seven cases of ``tests/test_clustering.py`` on the port: separated
blobs recovered with purity above 0.99; chunking invariance (padded
chunks) to 1e-4; the random init and assignment round trip; the npz
codebook's save and load; MFCC against scipy's DCT of the log filterbank;
``add_deltas``; and the whole iteration-1 recipe (audio -> MFCC + deltas
-> codebook -> int32 frame targets). Then the port against JAX: the same
seed gives the same k-means++ seeding and the same centroids and inertia
within 1e-4 on separated blobs, with and without a subsample and across
chunk sizes, the same labels; and a codebook written by either package
loads in the other and labels alike.
"""

import numpy as np
import pytest
import torch

from avsl_tpu.data.clustering import KMeansQuantizer as JaxQuantizer
from avsl_tpu.data.clustering import _pp_init as jax_pp_init
from avsl_tpu.data.clustering import kmeans_assign as jax_kmeans_assign
from avsl_tpu.data.clustering import kmeans_fit as jax_kmeans_fit
from avsl_tpu_torch.data.clustering import KMeansQuantizer, _pp_init, kmeans_assign, kmeans_fit
from avsl_tpu_torch.kernels.fbank import add_deltas, logfbank, mfcc
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)

CPU = dict(device="cpu")


def _blobs(seed=0, n_per=200, d=8, centers=((0,) * 8, (6,) * 8, (-6, 6) * 4)):
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for i, c in enumerate(centers):
        xs.append(rng.normal(size=(n_per, d)).astype(np.float32) + np.asarray(c))
        ys.append(np.full(n_per, i))
    return np.concatenate(xs), np.concatenate(ys)


def test_torch_kmeans_recovers_separated_blobs():
    x, y = _blobs()
    centroids, inertia = kmeans_fit(x, k=3, n_iters=25, seed=1, **CPU)
    labels = kmeans_assign(x, centroids, **CPU)
    mapping = {}
    for true in range(3):
        ids, counts = np.unique(labels[y == true], return_counts=True)
        assert counts.max() / counts.sum() > 0.99
        mapping[true] = ids[np.argmax(counts)]
    assert len(set(mapping.values())) == 3
    assert inertia < 1.5 * x.shape[0] * x.shape[1]


def test_torch_kmeans_chunking_invariance():
    x, _ = _blobs(seed=3, n_per=111)  # 333 points: the padded path
    c_small, i_small = kmeans_fit(x, k=3, n_iters=15, seed=5, chunk=64, **CPU)
    c_big, i_big = kmeans_fit(x, k=3, n_iters=15, seed=5, chunk=100000, **CPU)
    np.testing.assert_allclose(np.sort(c_small, axis=0), np.sort(c_big, axis=0), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(i_small, i_big, rtol=1e-4)


def test_torch_kmeans_random_init_and_assign_roundtrip():
    x, _ = _blobs(seed=7)
    centroids, _ = kmeans_fit(x, k=3, n_iters=20, seed=2, init="random", **CPU)
    assert centroids.shape == (3, x.shape[1])
    np.testing.assert_array_equal(kmeans_assign(centroids, centroids, **CPU), np.arange(3))
    labels = kmeans_assign(x.reshape(2, -1, x.shape[1]), centroids, **CPU)
    assert labels.shape == (2, x.shape[0] // 2) and labels.dtype == np.int32
    with pytest.raises(ValueError, match="unknown init"):
        kmeans_fit(x, k=3, init="bogus", **CPU)
    with pytest.raises(ValueError, match="at least k"):
        kmeans_fit(x[:2], k=3, **CPU)


def test_torch_quantizer_save_load_roundtrip(tmp_path):
    x, _ = _blobs(seed=9)
    q = KMeansQuantizer(**CPU).fit(x, k=3, n_iters=10, seed=0)
    path = str(tmp_path / "km.npz")
    q.save(path)
    q2 = KMeansQuantizer.load(path, **CPU)
    assert q2.n_clusters == 3
    np.testing.assert_array_equal(q(x), q2(x))
    with pytest.raises(ValueError, match="not fitted"):
        KMeansQuantizer(**CPU)(x)


def test_torch_mfcc_matches_scipy_dct_of_logfbank():
    from scipy.fftpack import dct as scipy_dct

    audio = np.random.default_rng(0).normal(size=16000).astype(np.float32)
    got = mfcc(audio, numcep=13, nfilt=26, **CPU).numpy()
    fb = logfbank(audio, nfilt=26, **CPU).numpy()
    want = scipy_dct(fb, type=2, axis=1, norm="ortho")[:, :13]
    n = np.arange(13)
    want = want * (1.0 + (22 / 2.0) * np.sin(np.pi * n / 22))[None, :]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert got.shape == (fb.shape[0], 13)


def test_torch_add_deltas_shapes_and_constant_input():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(10, 13)).astype(np.float32))
    out = add_deltas(x)
    assert out.shape == (10, 39)
    torch.testing.assert_close(out[:, :13], x, atol=0, rtol=0)
    np.testing.assert_allclose(add_deltas(torch.ones(10, 13))[:, 13:].numpy(), 0.0, atol=1e-7)
    assert add_deltas(x[None]).shape == (1, 10, 39)


def test_torch_mfcc_deltas_end_to_end_cluster_targets():
    rng = np.random.default_rng(2)
    t = np.arange(32000) / 16000.0
    audio = np.where((t * 2).astype(int) % 2 == 0, np.sin(2 * np.pi * 440 * t),
                     np.sin(2 * np.pi * 2200 * t)).astype(np.float32)
    audio += 0.01 * rng.normal(size=t.shape).astype(np.float32)
    feats = add_deltas(mfcc(audio, **CPU)).numpy()
    assert feats.shape[1] == 39
    q = KMeansQuantizer(**CPU).fit(feats, k=4, n_iters=15, seed=0)
    targets = q(feats)
    assert targets.shape == (feats.shape[0],) and targets.dtype == np.int32
    assert len(np.unique(targets)) >= 2


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def test_torch_kmeans_pp_init_is_jax_init():
    x, _ = _blobs(seed=4)
    np.testing.assert_array_equal(_pp_init(x, 5, np.random.default_rng(3)),
                                  jax_pp_init(x, 5, np.random.default_rng(3)))


@pytest.mark.parametrize("kw", [dict(k=3, n_iters=25, seed=1),
                                dict(k=5, n_iters=15, seed=2, chunk=100),
                                dict(k=3, n_iters=10, seed=3, init_subsample=300),
                                dict(k=4, n_iters=8, seed=4, init="random", chunk=64)],
                         ids=["pp", "pp_chunked_k5", "pp_subsample", "random_chunked"])
def test_torch_kmeans_matches_jax(kw):
    x, _ = _blobs(seed=kw["seed"] + 10, n_per=150)
    want_c, want_i = jax_kmeans_fit(x, **kw)
    got_c, got_i = kmeans_fit(x, **kw, **CPU)
    np.testing.assert_allclose(got_c, np.asarray(want_c), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_i, want_i, rtol=1e-4)
    np.testing.assert_array_equal(kmeans_assign(x, got_c, **CPU),
                                  np.asarray(jax_kmeans_assign(x, want_c)))


def test_torch_codebook_npz_crosses_packages(tmp_path):
    x, _ = _blobs(seed=11)
    ours = KMeansQuantizer(**CPU).fit(x, k=3, n_iters=10, seed=0)
    theirs = JaxQuantizer().fit(x, k=3, n_iters=10, seed=0)
    ours.save(str(tmp_path / "port.npz"))
    theirs.save(str(tmp_path / "jax.npz"))
    from_port = JaxQuantizer.load(str(tmp_path / "port.npz"))
    from_jax = KMeansQuantizer.load(str(tmp_path / "jax.npz"), **CPU)
    with np.load(tmp_path / "port.npz") as z:
        assert sorted(z.files) == ["centroids"]
    np.testing.assert_array_equal(from_port.centroids, ours.centroids)
    np.testing.assert_array_equal(from_jax.centroids, np.asarray(theirs.centroids))
    np.testing.assert_array_equal(np.asarray(from_port(x)), ours(x))
    np.testing.assert_array_equal(from_jax(x), np.asarray(theirs(x)))
