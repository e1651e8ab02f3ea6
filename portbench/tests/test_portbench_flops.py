"""``portbench/flops.py`` against hand-counted small cases."""

import pytest

from portbench import flops


def test_portbench_flops_linear_and_attention():
    assert flops.linear(3, 4, 5) == 2 * 3 * 4 * 5
    # scores 2*Tq*Tk*D per head and the weighted sum the same: 4 Tq Tk H D
    assert flops.attn(6, 10, 8) == 4 * 6 * 10 * 8
    assert flops.attn(10, 10, 8, causal=True) == 2 * 10 * 10 * 8


def test_portbench_flops_one_block_encoder():
    w = {"n_audio_state": 4, "n_audio_layer": 1, "n_mels": 2}
    t_mel = 8  # -> 4 frames after the stride-2 conv
    conv = 2 * 8 * 2 * 4 * 3 + 2 * 4 * 4 * 4 * 3
    qkvo = 4 * (2 * 4 * 4 * 4)
    mlp = 2 * (2 * 4 * 4 * 16)
    scores = 4 * 4 * 4 * 4
    assert flops.whisper_encoder(w, t_mel) == conv + qkvo + mlp + scores


def test_portbench_flops_kernel_launch_forward_backward_causal_lengths():
    fwd = flops.kernel_launch("fwd", b=2, h=3, tq=5, tk=7, d=4, itemsize=2, causal=False)
    assert fwd["ops"] == 2 * 4 * 5 * 7 * 3 * 4
    assert fwd["bytes"] == 2 * 3 * 4 * (2 * 5 + 2 * 7) * 2
    bwd = flops.kernel_launch("bwd", b=2, h=3, tq=5, tk=7, d=4, itemsize=2, causal=False)
    assert bwd["ops"] == 2 * fwd["ops"]
    assert bwd["bytes"] == 2 * 3 * 4 * (4 * 5 + 4 * 7) * 2 + 2 * 3 * 5 * 4 * 2
    causal = flops.kernel_launch("fwd", b=1, h=1, tq=8, tk=8, d=2, itemsize=4, causal=True)
    assert causal["ops"] == 4 * 8 * 8 * 2 / 2
    ragged = flops.kernel_launch("fwd", b=2, h=1, tq=4, tk=6, d=2, itemsize=2, causal=False,
                                 lengths=[6, 2])
    assert ragged["ops"] == 4 * 4 * 6 * 2 + 4 * 4 * 2 * 2
    assert ragged["bytes"] == 2 * 1 * 2 * (2 * 4 + 2 * 6) * 2 + 4 * 2


def test_portbench_flops_training_segment_counts_backward_twice_where_weights_learn():
    cfg = {"whisper": {"n_mels": 2, "n_audio_state": 4, "n_audio_layer": 1, "n_text_state": 4,
                       "n_text_layer": 1, "n_vocab": 10},
           "video_tower": {"visual_frontend_channels": 2, "visual_backbone_channels": 8,
                           "hidden_size": 4, "intermediate_size": 8, "conv_pos_groups": 2,
                           "conv_pos": 2, "num_hidden_layers": 1}}
    seg = flops.flamingo_train_segment(cfg, t_mel=8, frames=2, crop=8, label_len=3)
    towers = flops.whisper_encoder(cfg["whisper"], 8) + flops.video_tower(cfg["video_tower"], 2, 8)
    assert seg > towers
    fwd = flops.decoder_tokens(cfg["whisper"], 3, 3, 4, 2)
    assert seg >= towers + 2 * fwd


@pytest.mark.parametrize("new_tokens", [1, 4])
def test_portbench_flops_transcription_grows_with_tokens(new_tokens):
    cfg = {"whisper": {"n_mels": 2, "n_audio_state": 4, "n_audio_layer": 1, "n_text_state": 4,
                       "n_text_layer": 1, "n_vocab": 10},
           "video_tower": {"visual_frontend_channels": 2, "visual_backbone_channels": 8,
                           "hidden_size": 4, "intermediate_size": 8, "conv_pos_groups": 2,
                           "conv_pos": 2, "num_hidden_layers": 1}}
    one = flops.transcribe_segment(cfg, 8, 2, 8, 4, 1)
    more = flops.transcribe_segment(cfg, 8, 2, 8, 4, new_tokens)
    assert more == one + sum(flops.decoder_tokens(cfg["whisper"], 1, 4 + i, 4, 2)
                             for i in range(1, new_tokens))
