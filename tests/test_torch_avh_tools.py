"""The port's AV-HuBERT tools (``cli/_avh_common.py``, ``cli/extract.py``,
``cli/align.py``) against the JAX package's.

* Row intake equal; the row features (104-dim stacked logfbank, lip
  clip, bucket padding, truncate-to-min) within the filterbank's own
  tolerance (1e-4, ``test_torch_avhubert_features.py``), the lip frames
  and the padding exactly, for a wav path, a PCM array and an mp4 lip
  clip written with OpenCV, with frame counts that are no multiple of
  the bucket.
* JAX's two CLI tests (``tests/test_cli.py``) through the port.
* Both CLIs end to end against JAX's on the same weights: JAX's ``init``
  of the tiny card in fp32 (every weight and BatchNorm statistic
  perturbed), saved as a JAX checkpoint, restored and carried by
  ``avhubert_state_dict_from_flax`` into a port checkpoint, then both
  ``main``s with ``--ckpt_dir`` on one CSV. Features within atol 1e-3 +
  rtol 1e-3 (fp32; the inputs already differ by up to 1e-4), alignment
  scores within 1e-2 (a sum over the row's frames of float64 log
  posteriors from those logits), and the same words, the same frame
  spans and the same per-row errors (no text; more tokens than frames).
* The port, like JAX, passes no padding mask: a 25-frame row padded to
  32 gives JAX's features, not those of the same row with its pad frames
  masked.
* An empty ``--ckpt_dir`` is a SystemExit in both.
* A transcript of 64 tokens or more (over 127 alignment states): the JAX
  package's ``ctc_forced_align`` overflows its int8 backtrace under numpy
  2; the port's aligns it, with the best path's score (checked against an
  independent max-product recursion) and spans that score that path.
"""

import argparse
import csv
import dataclasses
import json

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from avsl_tpu.cli import _avh_common as jax_common
from avsl_tpu.decode.ctc import ctc_forced_align as jax_forced_align
from avsl_tpu.cli import align as jax_align
from avsl_tpu.cli import extract as jax_extract
from avsl_tpu.core.config import AVHuBERTConfig as JaxAVHuBERTConfig
from avsl_tpu.models.avhubert import AVHuBERTForCTC as JaxCTC
from avsl_tpu.train.checkpoints import restore_params_only, save_checkpoint as jax_save
from avsl_tpu_torch.cli import _avh_common as port_common
from avsl_tpu_torch.cli import align as port_align
from avsl_tpu_torch.cli import extract as port_extract
from avsl_tpu_torch.core.config import AVHuBERTConfig
from avsl_tpu_torch.data.audio_segments import write_wav
from avsl_tpu_torch.data.tokenizer import get_tokenizer
from avsl_tpu_torch.data.video_io import write_video_frames
from avsl_tpu_torch.decode.ctc import ctc_forced_align
from avsl_tpu_torch.models import (
    avhubert_state_dict_from_flax,
    build_avhubert,
    pretrain_state_dict_from_flax,
)
from avsl_tpu_torch.train import TrainState
from avsl_tpu_torch.train.checkpoints import save_checkpoint
from test_torch_avhubert_models import ZERO_RATES, perturb
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)

FEAT_TOL = dict(atol=1e-4, rtol=1e-4)
OUT_TOL = dict(atol=1e-3, rtol=1e-3)
SCORE_TOL = 1e-2
SR = 16000


def tone(seconds, hz=250.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    return (0.2 * np.sin(2 * np.pi * hz * t) + 0.02 * rng.standard_normal(len(t))).astype(
        np.float32)


def lip_clip(path, frames, seed=0, hw=96):
    return write_video_frames(
        str(path), np.random.default_rng(seed).integers(0, 255, (frames, hw, hw)).astype(np.uint8),
        fps=25)


def write_csv(path, rows, fields):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        for r in rows:
            w.writerow(r)
    return str(path)


# ---------------------------------------------------------------- row intake


def test_torch_rows_from_args_match_jax(tmp_path):
    path = write_csv(tmp_path / "s.csv", [{"id": "a", "audio": "x.wav", "video": ""},
                                          {"id": "", "audio": "y.wav", "video": "y.mp4"}],
                     ["id", "audio", "video"])
    no_id = write_csv(tmp_path / "n.csv", [{"audio": "x.wav"}, {"audio": "z.wav"}], ["audio"])
    for ns in (argparse.Namespace(csv=path), argparse.Namespace(csv=no_id),
               argparse.Namespace(csv=None, audio="s.wav", video=None, id="7"),
               argparse.Namespace(csv=None, audio="s.wav", video="s.mp4", id="0")):
        assert port_common.rows_from_args(ns) == jax_common.rows_from_args(ns)
    assert [r["id"] for r in port_common.rows_from_args(argparse.Namespace(csv=no_id))] == \
        ["0", "1"]
    for mod in (port_common, jax_common):
        with pytest.raises(SystemExit, match="need --audio or --csv"):
            mod.rows_from_args(argparse.Namespace(csv=None, audio=None))


@pytest.mark.parametrize("kind,bucket", [("wav", 32), ("pcm", 16), ("lip_clip", 32)])
def test_torch_load_row_features_match_jax(tmp_path, kind, bucket):
    audio = tone(1.37, seed=1)  # 34 frames: no multiple of either bucket
    row = {"id": "r", "audio": audio}
    if kind != "pcm":
        row["audio"] = write_wav(str(tmp_path / "a.wav"), audio)
    if kind == "lip_clip":
        row["video"] = lip_clip(tmp_path / "a-lip.mp4", 29)  # truncates the audio to 29
    want_a, want_v, want_t = jax_common.load_row_features(row, bucket)
    got_a, got_v, got_t = port_common.load_row_features(row, bucket, device="cpu")
    assert got_t == want_t == (29 if kind == "lip_clip" else 34)
    assert got_a.shape == want_a.shape and got_v.shape == want_v.shape
    assert got_a.shape[1] % bucket == 0 and got_a.shape[1] > got_t
    np.testing.assert_allclose(got_a, want_a, **FEAT_TOL)
    np.testing.assert_array_equal(got_v, want_v)
    assert not got_a[0, got_t:].any() and not got_v[0, got_t:].any()
    if kind == "lip_clip":
        assert got_v[0, :got_t].std() > 0.5


# ------------------------------------------------------ JAX's CLI tests, port


def test_torch_align_cli_smoke_and_csv(tmp_path):
    out = port_align.main(["--smoke", "--device", "cpu"])
    assert out[0]["id"] == "smoke"
    words = out[0]["words"]
    assert [w["word"] for w in words] == ["hello", "world"]
    assert all(w["end_s"] > w["start_s"] >= 0 for w in words)
    assert words[0]["end_s"] <= words[1]["start_s"] + 1e-6

    wav = write_wav(str(tmp_path / "a.wav"), (0.2 * np.sin(
        2 * np.pi * 250 * np.arange(SR) / SR)).astype(np.float32))
    csv_path = write_csv(tmp_path / "segs.csv", [{"id": "s1", "audio": wav, "text": " one two"},
                                                 {"id": "s2", "audio": wav, "text": " three"}],
                         ["id", "audio", "text"])
    out_path = str(tmp_path / "aligned.json")
    results = port_align.main(["--csv", csv_path, "--tiny", "--output", out_path,
                               "--device", "cpu"])
    assert [r["id"] for r in results] == ["s1", "s2"]
    assert [w["word"] for w in results[0]["words"]] == ["one", "two"]
    assert [w["word"] for w in results[1]["words"]] == ["three"]
    with open(out_path) as f:
        assert json.load(f) == results


def test_torch_extract_cli_dumps_features(tmp_path):
    wav = write_wav(str(tmp_path / "a.wav"), (0.2 * np.sin(
        2 * np.pi * 250 * np.arange(SR) / SR)).astype(np.float32))
    lip = lip_clip(tmp_path / "a-lip.mp4", 25)
    csv_path = write_csv(tmp_path / "segs.csv", [{"id": "av", "audio": wav, "video": lip},
                                                 {"id": "a", "audio": wav, "video": ""}],
                         ["id", "audio", "video"])
    out = str(tmp_path / "feats")
    results = port_extract.main(["--csv", csv_path, "--tiny", "--output", out,
                                 "--device", "cpu"])
    assert [r["id"] for r in results] == ["av", "a"]
    f_av, f_a = np.load(results[0]["path"]), np.load(results[1]["path"])
    assert f_av.ndim == 2 and f_av.shape == f_a.shape and f_av.dtype == np.float32
    assert np.isfinite(f_av).all()
    assert np.abs(f_av - f_a).max() > 0  # the video stream reached fusion
    r2 = port_extract.main(["--audio", wav, "--tiny", "--output", str(tmp_path / "feats_l1"),
                            "--layer", "1", "--device", "cpu"])
    f_l1 = np.load(r2[0]["path"])
    assert f_l1.shape == f_a.shape
    assert np.abs(f_l1 - f_a).max() > 0  # tap != final output


# ------------------------------------------------- end to end, same weights


@pytest.fixture(scope="module")
def same_weights(tmp_path_factory):
    """A tiny fp32 card (every rate 0) as a YAML both packages read, JAX
    and port checkpoints of the same perturbed CTC weights (and of its
    encoder for ``extract``), and a CSV: a 1 s wav (25 frames, 7 pad
    frames at bucket 32), a 1.3 s wav with a 30-frame lip clip (30
    frames), a row without text and one with more tokens than frames."""
    d = tmp_path_factory.mktemp("avh_tools")
    vocab = get_tokenizer(None, "en").vocab_size
    fields = dataclasses.asdict(JaxAVHuBERTConfig.tiny_test(dtype="float32", vocab_size=vocab,
                                                            **ZERO_RATES))
    card = str(d / "card.yaml")
    with open(card, "w") as f:
        yaml.safe_dump({k: list(v) if isinstance(v, tuple) else v for k, v in fields.items()}, f)
    assert dataclasses.asdict(AVHuBERTConfig.from_yaml(card)) == \
        dataclasses.asdict(JaxAVHuBERTConfig.from_yaml(card)) == fields

    jcfg = JaxAVHuBERTConfig.from_yaml(card)
    audio = jnp.zeros((1, 32, 104))
    video = jnp.zeros((1, 32, 88, 88, 1))
    init = jax.jit(lambda key: JaxCTC(jcfg).init(key, audio=audio, video=video))
    variables = perturb(init(jax.random.PRNGKey(0)), np.random.default_rng(5))
    encoder = {k: v["avhubert"] for k, v in variables.items()}
    ckpt = {}
    for name, tree in (("ctc", variables), ("encoder", encoder)):
        jax_dir = str(d / f"jax_{name}")
        jax_save(jax_dir, tree, 1)
        restored = restore_params_only(jax_dir)
        if name == "ctc":
            sd = avhubert_state_dict_from_flax(restored["params"], restored["batch_stats"])
        else:
            sd = pretrain_state_dict_from_flax({"avhubert": restored["params"]},
                                               {"avhubert": restored["batch_stats"]})
        model = build_avhubert(AVHuBERTConfig.from_yaml(card), name, device="cpu")
        model.load_state_dict(sd, strict=True)
        port_dir = str(d / f"port_{name}")
        save_checkpoint(port_dir, TrainState.create(model, None), 1)
        ckpt[name] = (jax_dir, port_dir)

    wav1 = write_wav(str(d / "one.wav"), tone(1.0, seed=2))
    wav2 = write_wav(str(d / "two.wav"), tone(1.3, hz=180.0, seed=3))
    rows = [{"id": "pad", "audio": wav1, "video": "", "text": " one two"},
            {"id": "av", "audio": wav2, "video": lip_clip(d / "two-lip.mp4", 30, seed=4),
             "text": " three four"},
            {"id": "notext", "audio": wav1, "video": "", "text": ""},
            {"id": "toolong", "audio": wav1, "video": "", "text": " " + "x" * 40}]
    table = write_csv(d / "segs.csv", rows, ["id", "audio", "video", "text"])
    return d, card, ckpt, table


def test_torch_extract_cli_matches_jax_on_same_weights(same_weights):
    d, card, ckpt, table = same_weights
    jax_dir, port_dir = ckpt["encoder"]
    for layer in ([], ["--layer", "1"]):
        tag = "".join(layer)
        want = jax_extract.main(["--csv", table, "--config", card, "--ckpt_dir", jax_dir,
                                 "--output", str(d / f"jf{tag}"), *layer])
        got = port_extract.main(["--csv", table, "--config", card, "--ckpt_dir", port_dir,
                                 "--output", str(d / f"pf{tag}"), "--device", "cpu", *layer])
        assert [r["id"] for r in got] == [r["id"] for r in want]
        assert [r["shape"] for r in got] == [r["shape"] for r in want]
        assert got[0]["shape"] == [25, 32] and got[1]["shape"] == [30, 32]
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.load(g["path"]), np.load(w["path"]), **OUT_TOL,
                                       err_msg=f"{g['id']} {tag}")


def test_torch_extract_passes_no_padding_mask(same_weights):
    """Row "pad" (25 frames in a bucket of 32): the CLI's features are
    JAX's, and differ from the port's own with the 7 pad frames masked."""
    d, card, ckpt, _ = same_weights
    jax_dir, port_dir = ckpt["encoder"]
    wav = str(d / "one.wav")
    want = np.load(jax_extract.main(["--audio", wav, "--config", card, "--ckpt_dir", jax_dir,
                                     "--output", str(d / "jpad")])[0]["path"])
    got = np.load(port_extract.main(["--audio", wav, "--config", card, "--ckpt_dir", port_dir,
                                     "--output", str(d / "ppad"), "--device", "cpu"])[0]["path"])
    np.testing.assert_allclose(got, want, **OUT_TOL)
    model = port_common.maybe_restore_variables(
        port_dir, build_avhubert(AVHuBERTConfig.from_yaml(card), "encoder", device="cpu"))
    pad_a, pad_v, t = port_common.load_row_features({"audio": wav}, 32, device="cpu")
    assert (t, pad_a.shape[1]) == (25, 32)
    with torch.no_grad():
        masked = model.extract_features(
            audio=torch.from_numpy(pad_a), video=torch.from_numpy(pad_v),
            padding_mask=torch.arange(32)[None] < t)[0, :t].numpy()
    assert np.abs(masked - want).max() > 100 * OUT_TOL["atol"]


def test_torch_align_cli_matches_jax_on_same_weights(same_weights):
    d, card, ckpt, table = same_weights
    jax_dir, port_dir = ckpt["ctc"]
    want = jax_align.main(["--csv", table, "--config", card, "--ckpt_dir", jax_dir,
                           "--output", str(d / "j.json")])
    got = port_align.main(["--csv", table, "--config", card, "--ckpt_dir", port_dir,
                           "--output", str(d / "p.json"), "--device", "cpu"])
    assert [r["id"] for r in got] == ["pad", "av", "notext", "toolong"]
    assert got[2] == want[2] == {"id": "notext", "error": "missing transcript text"}
    assert got[3] == want[3] and "cannot emit" in got[3]["error"]
    for g, w in zip(got[:2], want[:2]):
        assert g["n_frames"] == w["n_frames"] and g["words"] == w["words"], (g, w)
        assert abs(g["score"] - w["score"]) <= SCORE_TOL, (g["score"], w["score"])
        assert all(x["end_s"] > x["start_s"] >= 0 for x in g["words"])
    assert [w["word"] for w in got[1]["words"]] == ["three", "four"]
    with open(d / "p.json") as f:
        assert json.load(f) == got


@pytest.mark.parametrize("cli", ["extract", "align"])
def test_torch_empty_ckpt_dir_is_a_system_exit(same_weights, cli, tmp_path):
    _, card, _, _ = same_weights
    wav = str(same_weights[0] / "one.wav")
    empty = str(tmp_path / "empty")
    args = ["--audio", wav, "--config", card, "--ckpt_dir", empty, "--output",
            str(tmp_path / ("o" if cli == "extract" else "o.json"))]
    jax_main, port_main = {"extract": (jax_extract.main, port_extract.main),
                           "align": (jax_align.main, port_align.main)}[cli]
    if cli == "align":
        args += ["--text", " hi"]
    for main, extra in ((jax_main, []), (port_main, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="no checkpoint under"):
            main(args + extra)


def test_torch_forced_align_past_127_states():
    rng = np.random.default_rng(8)
    t, vocab, blank = 300, 40, 1
    logits = rng.normal(size=(t, vocab))
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    tokens = [int(x) for x in rng.integers(2, vocab, 70)]
    with pytest.raises(OverflowError):
        jax_forced_align(lp, tokens, blank_id=blank)
    spans, score = ctc_forced_align(lp, tokens, blank_id=blank)

    ext = [blank]
    for tok in tokens:
        ext += [tok, blank]
    best = np.full(len(ext), -np.inf)
    best[:2] = lp[0, ext[:2]]
    for f in range(1, t):
        prev = best.copy()
        for s in range(len(ext)):
            cands = [prev[s]] + ([prev[s - 1]] if s else [])
            if s >= 2 and ext[s] != blank and ext[s] != ext[s - 2]:
                cands.append(prev[s - 2])
            best[s] = max(cands) + lp[f, ext[s]]
    assert score == pytest.approx(max(best[-1], best[-2]), abs=1e-9)

    assert len(spans) == len(tokens)
    assert all(a < b for a, b in spans) and spans[0][0] >= 0 and spans[-1][1] <= t
    assert all(b1 <= a2 for (_, b1), (a2, _) in zip(spans, spans[1:]))
    labels = np.full(t, blank)
    for tok, (a, b) in zip(tokens, spans):
        labels[a:b] = tok
    assert lp[np.arange(t), labels].sum() == pytest.approx(score, abs=1e-9)
