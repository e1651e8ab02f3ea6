"""Model operations of Auto-AVSR's audio-visual model, counted from shapes
as ``flops.py`` counts them: a product of [m, k] by [k, n] is 2 m k n,
attention 4 Tq Tk H D forward (halved under a causal mask), a
convolution 2 x outputs x its kernel's taps x input channels a group;
elementwise work, norms, pooling and the softmax are not counted. A
training step is its forward and a backward of twice that (every tensor
trained); no rematerialised forward is counted.

The relative-position attention's positional scores ``(q + v) p^T`` are
T x (2T - 1) products a head, and ``p = W_pos pe`` is one [2T - 1, d] x
[d, d] product a block and forward, shared by the batch.
"""

from __future__ import annotations

from portbench.flops import attn, linear, resnet_frame


def conformer_block(m: dict, t: int) -> float:
    """One row's share of a Conformer block over ``t`` frames, without the
    batch-shared positional projection (:func:`positions`)."""
    d, f, k = m["adim"], m["eunits"], m["cnn_module_kernel"]
    ffn = 2 * (linear(t, d, f) + linear(t, f, d))
    mhsa = 4 * linear(t, d, d) + attn(t, t, d) + 2.0 * t * (2 * t - 1) * d
    conv = linear(t, d, 2 * d) + 2.0 * t * d * k + linear(t, d, d)
    return ffn + mhsa + conv


def positions(m: dict, t: int) -> float:
    """The positional projection of one block and forward (the batch's)."""
    return linear(2 * t - 1, m["adim"], m["adim"])


def audio_resnet(m: dict, samples: int) -> float:
    """One row of PCM through the ResNet-1D (the partial frame cut)."""
    bc = m["audio_backbone_channels"]
    planes = (max(bc // 8, 8), max(bc // 4, 8), max(bc // 2, 8), bc)
    n = samples // 640 * 640
    length = (n + 2 * 38 - 80) // 4 + 1
    ops = 2.0 * length * planes[0] * 80
    c_in = planes[0]
    for stage, width in enumerate(planes):
        for blk in range(2):
            stride = 2 if stage > 0 and blk == 0 else 1
            length = (length - 1) // stride + 1
            ops += 2.0 * length * width * c_in * 3 + 2.0 * length * width * width * 3
            if blk == 0 and (stage > 0 or c_in != width):
                ops += 2.0 * length * width * c_in
            c_in = width
    return ops


def decoder(m: dict, label_len: int, frames: int) -> float:
    """One row of the teacher-forced decoder over ``label_len`` positions
    and ``frames`` memory frames, with its output layer."""
    dd, du = m["ddim"], m["dunits"]
    layer = (4 * linear(label_len, dd, dd) + attn(label_len, label_len, dd, causal=True)
             + 2 * linear(label_len, dd, dd) + 2 * linear(frames, m["adim"], dd)
             + attn(label_len, frames, dd)
             + linear(label_len, dd, du) + linear(label_len, du, dd))
    return m["dlayers"] * layer + linear(label_len, dd, m["odim"])


def train_step(m: dict, batch: int, frames: int, samples: int, label_len: int) -> float:
    """One training micro-step of ``batch`` rows of ``frames`` lip frames
    (h x h, ``image_crop_size``), ``samples`` of PCM and ``label_len``
    decoder positions: both frontends, both embeddings and Conformer
    stacks, the fusion, the CTC head and the decoder, forward and a
    backward of twice that."""
    d = m["adim"]
    row = frames * resnet_frame(m, m["image_crop_size"]) + audio_resnet(m, samples)
    row += linear(frames, m["visual_backbone_channels"], d)
    row += linear(frames, m["audio_backbone_channels"], d)
    row += 2 * m["elayers"] * conformer_block(m, frames)
    row += linear(frames, 2 * d, m["fusion_hdim"]) + linear(frames, m["fusion_hdim"], d)
    row += linear(frames, d, m["odim"]) + decoder(m, label_len, frames)
    shared = 2 * m["elayers"] * positions(m, frames)
    return 3.0 * (batch * row + shared)
