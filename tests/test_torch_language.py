"""Language identification of the port (decode/language.py) against the
JAX package's (CPU): one decode step from ``<|sot|>`` on the tiny
audio-only and Whisper-Flamingo models, the posterior over the
tokenizer's language tokens within 1e-5 of JAX's and the same best
language; and ``cli.transcribe --detect_language`` on the CPU.
"""

import os

import numpy as np
import pytest

from avsl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from avsl_tpu.decode import detect_language as jax_detect_language
from avsl_tpu_torch.cli.transcribe import main as transcribe_main
from avsl_tpu_torch.data.audio_segments import write_wav
from avsl_tpu_torch.data.tokenizer import ByteTokenizer
from avsl_tpu_torch.decode.language import detect_language, language_token_ids
from test_torch_flamingo_common import one_torch_thread  # noqa: F401
from torch_serving_fixtures import carried_models


@pytest.mark.parametrize("av", [False, True], ids=["audio_only", "av"])
def test_torch_detect_language_matches_jax(av):
    jmodel, variables, port = carried_models(av=av, seed=21)
    audio = (0.1 * np.random.default_rng(22).standard_normal((3, 16000))).astype(np.float32)
    want = jax_detect_language(jmodel, variables, JaxByteTokenizer(), audio)
    port.train()  # served in eval mode, handed back in training mode
    got = detect_language(port, ByteTokenizer(), audio)
    assert port.training
    langs, _ = language_token_ids(ByteTokenizer())
    assert len(got) == 3 and len(langs) == 99
    for (wb, wt), (gb, gt) in zip(want, got):
        assert gb == wb and list(gt) == list(wt) == langs
        np.testing.assert_allclose([gt[l] for l in langs], [wt[l] for l in langs], atol=1e-5,
                                   rtol=0)
        assert abs(sum(gt.values()) - 1.0) <= 1e-4
    assert len({gb for gb, _ in got}) >= 1 and max(got[0][1].values()) < 0.999  # not one-hot


def test_torch_transcribe_cli_detect_language_and_words(tmp_path):
    rng = np.random.default_rng(23)
    for name in ("a", "b", "c"):
        write_wav(os.path.join(tmp_path, f"{name}.wav"),
                  (0.2 * rng.standard_normal(12000)).astype(np.float32))
    out = transcribe_main(["--input", str(tmp_path), "--smoke", "--device", "cpu",
                           "--batch_size", "2", "--max_new_tokens", "4", "--detect_language",
                           "--word_timestamps", "--temperature_fallback", "0.5,1.0"])
    assert [r["id"] for r in out] == ["a", "b", "c"]
    for r in out:
        assert r["language"] in language_token_ids(ByteTokenizer())[0]
        assert 0.0 < r["language_prob"] <= 1.0
        assert isinstance(r["words"], list)
        for w in r["words"]:
            assert 0.0 <= w["start_s"] <= w["end_s"] <= 12000 / 16000 + 0.02
