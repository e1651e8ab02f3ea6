"""The plain reference against the port at tiny_test sizes on the CPU,
from the same seed-made weights and inputs. The test imports both; the
reference imports neither the port nor the JAX package."""

import json

import numpy as np
import pytest
import torch

from portbench import data, weights
from portbench.reference import precision, spec, tokens, whisper_flamingo as ref
from portbench.reference.audio import log_mel, spec_augment

from .conftest import TINY

CFG = json.loads((TINY / "configs" / "tiny_flamingo.json").read_text())


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _program(dtype="float32"):
    from avsl_tpu_torch.models.factory import build_whisper_flamingo

    model, _ = build_whisper_flamingo("test", vocab_size=CFG["whisper"]["n_vocab"],
                                      add_gated_x_attn=1, use_av_hubert_encoder=True,
                                      dtype=dtype, device="cpu")
    return model


def test_portbench_reference_state_dict_names_and_shapes_are_the_programs():
    model = _program()
    sd = weights.make(spec.whisper_flamingo(CFG), 11, "cpu")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want


def test_portbench_reference_log_mel_matches_the_programs():
    from avsl_tpu_torch.kernels.logmel import log_mel_spectrogram

    audio = torch.from_numpy(data.audio(3, 1.0, 5, "cpu"))
    np.testing.assert_allclose(log_mel(audio).numpy(), log_mel_spectrogram(audio).numpy(),
                               atol=1e-5)


def test_portbench_reference_teacher_forced_logits_match_the_program():
    model = _program()
    sd = weights.make(spec.whisper_flamingo(CFG), 12, "cpu")
    model.load_state_dict(sd)
    audio = torch.from_numpy(data.audio(2, 1.0, 6, "cpu"))
    video = torch.from_numpy(data.normalise(data.lip_frames(2, 25, 88, 6, "cpu")))
    toks = torch.randint(0, 361, (2, 9), generator=torch.Generator().manual_seed(0))
    from avsl_tpu_torch.kernels.logmel import log_mel_spectrogram

    with torch.no_grad():
        got = model(log_mel_spectrogram(audio), toks, video=video[..., None])
        want = ref.forward(precision.Precision(), sd, CFG, log_mel(audio), toks, video,
                           ref.Draws())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=1e-5)


def test_portbench_reference_spec_augment_draws_the_programs_masks():
    from avsl_tpu_torch.kernels.specaugment import spec_augment_batch

    mel = torch.randn(3, 80, 100)
    frames = torch.tensor([100, 60, 7])
    got = spec_augment_batch(mel.transpose(1, 2), torch.Generator().manual_seed(4), frames,
                             n_freq_mask=1, n_time_mask=1).transpose(1, 2)
    want = spec_augment(mel, frames, torch.Generator().manual_seed(4), 1, 1)
    assert torch.equal(got, want)


def test_portbench_reference_tokens_match_the_tokenizer_and_collator():
    from avsl_tpu_torch.data.runtime import WhisperVideoCollator
    from avsl_tpu_torch.data.tokenizer import get_tokenizer

    tok = get_tokenizer(None, "en")
    tok.add_tokens(["<laugh>"])
    texts = data.transcripts(5, {"min_words": 1, "max_words": 60, "pareto_alpha": 1.2}, 9)
    items = [{"input_ids": np.zeros((80, 4), np.float32), "audio_frames": 4,
              **{k: np.asarray(v) for k, v in tok.prepare_example(t, "en").items()}}
             for t in texts]
    batch = WhisperVideoCollator(tok.eot, label_pad_len=32, max_label_len=32)(items)
    dec, lab = tokens.batch(texts, 32)
    assert np.array_equal(batch["dec_input_ids"], dec)
    assert np.array_equal(batch["labels"], lab)
    assert tok.sot_sequence("en") == tokens.PROMPT and tok.eot == tokens.EOT


def test_portbench_reference_fp8_control_rounds_products():
    x = torch.randn(16, 32)
    w = torch.randn(8, 32)
    exact = precision.Precision("fp32").mm(x, w)
    low = precision.Precision("fp8").mm(x, w)
    rel = ((low - exact).norm() / exact.norm()).item()
    assert 1e-3 < rel < 0.2


AVH = json.loads((TINY / "configs" / "tiny_avhubert.json").read_text())["model"]


def _avhubert():
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.models import build_avhubert

    return build_avhubert(AVHuBERTConfig(**dict(AVH, dtype="float32")), "seq2seq", device="cpu")


def test_portbench_reference_avhubert_state_dict_is_the_programs():
    from portbench.reference import avhubert as ref_avh

    model = _avhubert()
    sd = weights.make(ref_avh.spec(AVH), 13, "cpu")
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}


def test_portbench_reference_avhubert_config_is_the_model_card():
    import dataclasses

    from avsl_tpu_torch.core.config import AVHuBERTConfig

    from .conftest import ROOT

    card = dataclasses.asdict(AVHuBERTConfig.from_yaml(str(ROOT / "configs" /
                                                           "avhubert_large.yaml")))
    model = json.loads((ROOT / "portbench" / "configs" / "avhubert_large.json").read_text())
    for key, value in model["model"].items():
        assert card[key] == value, key


def test_portbench_reference_avhubert_logits_match_the_program():
    from portbench.reference import avhubert as ref_avh

    model = _avhubert()
    sd = weights.make(ref_avh.spec(AVH), 14, "cpu")
    model.load_state_dict(sd)
    g = torch.Generator().manual_seed(1)
    audio = torch.randn(2, 12, 104, generator=g)
    video = torch.from_numpy(data.normalise(data.lip_frames(2, 12, 88, 8, "cpu")))
    dec = torch.tensor([[0, 5, 9, 7, 1, 1], [0, 4, 4, 8, 9, 6]])
    valid = torch.ones(2, 12, dtype=torch.bool)
    with torch.no_grad():
        got = model(audio=audio, video=video[..., None], decoder_input_ids=dec,
                    padding_mask=valid)["logits"]
        enc = ref.avhubert_encoder(precision.Precision(), sd, AVH, audio, video, ref.Draws(),
                                   valid, pre="encoder.w2v_model")
        want = ref_avh.decoder(precision.Precision(), sd, AVH, dec, enc, valid, ref.Draws())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-5, rtol=1e-5)
