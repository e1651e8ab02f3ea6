"""Inputs shared by the lip-frontend parity tests (tests/test_torch_lip_*.py,
test_torch_host_crops.py, test_torch_pipeline.py): seeded numpy clips at
the JAX lip tests' small size (40 frames of 144 x 176)."""

import numpy as np

T, H, W = 40, 144, 176
DS = 2
WINDOW = 25


def blob_clips(b=2, t=T, h=H, w=W, seed=0):
    """Moving-blob closeups with a flickering mouth, uint8 [b, t, h, w]
    (the construction of tests/test_lip_pipeline.py)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 200, (h, w)).astype(np.float32)
    clips = np.empty((b, t, h, w), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for bi in range(b):
        cx, cy = w // 2 + 5 * bi, h // 2
        for ti in range(t):
            jitter = 4 * np.sin(ti / 7 + bi)
            face = 80 * np.exp(-(((xx - cx - jitter) / 30.0) ** 2 + ((yy - cy) / 40.0) ** 2))
            mouth = 40 * (ti % 2) * np.exp(-(((xx - cx) / 8.0) ** 2 + ((yy - cy - 18) / 6.0) ** 2))
            clips[bi, ti] = np.clip(base + face + mouth, 0, 255).astype(np.uint8)
    return clips


def closeup_clips(b=2, t=T, h=H, w=W, seed=0):
    """Raw closeups the motion detector finds, uint8 [b, t, h, w]: the
    moving-blob construction above with a textured head that moves over a
    static background (sideways by 5 % of the width, up and down by 2 % of
    the height) and a mouth that darkens every other frame, 0.14 h below
    the head's centre. Sizes scale with the frame."""
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 200, (h, w)).astype(np.float32)
    tex = rng.integers(0, 90, (h, w)).astype(np.float32)
    clips = np.empty((b, t, h, w), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for bi in range(b):
        cx, cy = w / 2 + 0.03 * w * bi, h / 2
        for ti in range(t):
            jx = 0.05 * w * np.sin(ti / 7 + bi)
            jy = 0.02 * h * np.sin(ti / 11 + bi)
            env = np.exp(-((((xx - cx - jx) / (0.17 * w)) ** 2
                            + ((yy - cy - jy) / (0.28 * h)) ** 2) ** 2))
            head = 90 + np.roll(tex, (int(round(jy)), int(round(jx))), axis=(0, 1))
            mouth = 70 * (ti % 2) * np.exp(-(((xx - cx - jx) / (0.05 * w)) ** 2
                                             + ((yy - cy - jy - 0.14 * h) / (0.035 * h)) ** 2))
            clips[bi, ti] = np.clip(base * (1 - env) + head * env - mouth, 0, 255).astype(np.uint8)
    return clips


def face_clip(t=T, h=H, w=W, seed=0, sweep=12.0):
    """A rendered talking face (head ellipse, lip line that opens and
    closes, chin crease, nose shadow; tests/test_lip_refine_stress.py's
    renderer) whose mouth sweeps ``sweep`` px sideways: uint8 [t, h, w]
    and the true mouth centres [t, 2]."""
    from test_lip_refine_stress import make_clip

    rng = np.random.default_rng(seed)
    cx = np.linspace(w / 2 - sweep / 2, w / 2 + sweep / 2, t)
    cy = np.full(t, 0.62 * h)
    fw = np.full(t, 0.4 * w)
    return make_clip(t, h, w, cx, cy, fw, rng), np.stack([cx, cy], -1)


def landmarks_for(clips_shape, seed=0, rotate=0.0):
    """Per-frame 68-point landmarks [..., 68, 2] for frames of
    ``clips_shape`` [..., H, W]: the canonical face scaled to about half
    the frame, centred with a per-frame jitter, rotated by ``rotate``
    radians (plus a little noise)."""
    from avsl_tpu_torch.data.lip_roi import canonical_mean_face

    rng = np.random.default_rng(seed)
    lead, (h, w) = clips_shape[:-2], clips_shape[-2:]
    canon = canonical_mean_face(300).astype(np.float64) - 150.0
    s = 0.45 * min(h, w) / 156.0
    ang = rotate + 0.01 * rng.standard_normal(lead)
    c, sn = np.cos(ang)[..., None], np.sin(ang)[..., None]
    x = s * (c * canon[:, 0] - sn * canon[:, 1])
    y = s * (sn * canon[:, 0] + c * canon[:, 1])
    shift = np.stack([w / 2 + 3 * rng.standard_normal(lead), h / 2 + 3 * rng.standard_normal(lead)], -1)
    lms = np.stack([x, y], -1) + shift[..., None, :]
    return (lms + 0.3 * rng.standard_normal(lms.shape)).astype(np.float32)


# The crop-window centre of a warp is truncated to int32, and for
# synthesized landmarks (an affine image of the canonical layout) the warped
# mouth centre is the canonical 150.0 / 218.0 up to rounding: XLA's float32
# order (which also differs from one XLA program to another) and the port's
# fixed order can land on either side. A crop may sit one pixel off the JAX
# one only along an axis where the reference's centre is this close to the
# edge.
KNIFE_EDGE_PX = 1e-3
STABLE = (33, 36, 39, 42, 45)


def knife_edge(lms, out_size=300, crop_size=96):
    """[..., 2] bool: whether the JAX package's crop-window centre (x, y)
    of each frame lies within KNIFE_EDGE_PX of the int32 truncation edge."""
    import jax
    import jax.numpy as jnp

    from avsl_tpu.data.lip_roi import canonical_mean_face
    from avsl_tpu.kernels import warp as jw

    mf = jnp.asarray(canonical_mean_face(out_size))
    half = crop_size // 2

    def centre(lms):
        coeffs = jw.similarity_coeffs(lms[..., STABLE, :], mf[np.asarray(STABLE)])
        return jnp.mean(jw.apply_coeffs(lms[..., 48:68, :], coeffs), axis=-2)

    c = np.clip(np.asarray(jax.jit(centre)(jnp.asarray(lms))), half, out_size - half)
    return np.abs(c - np.round(c)) < KNIFE_EDGE_PX


def _aligned_err(g, w, shift):
    """max |g[i, j] - w[i + dy, j + dx]| over the overlap (1-D: g[j] vs
    w[j + dx])."""
    gi, wi = [], []
    for n, d in zip(g.shape, shift[::-1]):  # shift is (dx[, dy]); the last axis is x
        gi.append(slice(max(0, -d), n - max(0, d)))
        wi.append(slice(max(0, d), n - max(0, -d)))
    return float(np.abs(g[tuple(gi)] - w[tuple(wi)]).max())


def assert_crops_match(got, want, lms_want, atol, axes="xy"):
    """Each frame of ``got`` ([..., c, c] crops, or [..., c] coordinates
    along ``axes`` "x" or "y") equals the JAX ``want`` within ``atol``, or
    does so one pixel over along an axis where the reference's crop-window
    centre is on the knife edge (for ``lms_want``, the JAX landmarks)."""
    edge = knife_edge(lms_want)
    got, want = np.asarray(got), np.asarray(want)
    n_axes = 2 if axes == "xy" else 1
    frame = got.shape[got.ndim - n_axes:]
    got, want = got.reshape((-1,) + frame), want.reshape((-1,) + frame)
    cols = {"xy": [0, 1], "x": [0], "y": [1]}[axes]
    edge = edge.reshape(-1, 2)[:, cols]
    worst, moved = 0.0, 0
    for g, w, e in zip(got, want, edge):
        options = [[0, -1, 1] if on_edge else [0] for on_edge in e]
        shifts = [(a, b) for a in options[0] for b in options[1]] if n_axes == 2 else \
            [(a,) for a in options[0]]
        errs = {sh: _aligned_err(g, w, sh) for sh in shifts}
        best = min(errs, key=errs.get)
        worst = max(worst, errs[best])
        moved += any(best)
    assert worst <= atol, f"max abs difference {worst} over {atol} ({moved} frames a pixel over)"
