"""The port's dataset layer against the JAX package's (CPU): the cases of
``tests/test_data_l3.py``, each run through both packages.

Audio slices and the files written are bit-equal to JAX's, and video
clips cut from a closeup equal JAX's frame for frame (native decode and
OpenCV's seek); chunked
processing (resume, mid-chunk resume, the chunk-size remap, the guarded
pool, whose workers the port spawns) gives JAX's results and
checkpoints; the CSV merge writes JAX's CSV; HF packaging (the column union), the sharded
round trip (records back in order), ``split_dataset`` and the push
back-off equal JAX's; the marker pipeline gives JAX's segments, stats and
sanitised or deduplicated ids; ``segment_sources``, the AMI segments CSV
loader and the existing-segments mode give JAX's records;
``reprocess_lips_from_csv`` crops a face clip as JAX does (within
``torch_lip_fixtures.assert_crops_match``); and the port's dataset
fixture writer gives the JAX writer's columns and rows.
"""

import csv
import json
import multiprocessing as mp
import os

import numpy as np
import pandas as pd
import pytest
import scipy.io.wavfile as wavfile

from avsl_tpu.data import audio_segments as j_audio
from avsl_tpu.data import chunked as j_chunked
from avsl_tpu.data import dataset_process as j_dp
from avsl_tpu.data import hf_dataset as j_hf
from avsl_tpu.data.segments import Segment as JSegment
from avsl_tpu_torch.data import audio_segments, chunked, dataset_process, hf_dataset
from avsl_tpu_torch.data.segments import Segment
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)
from torch_dataset_fixtures import boom_on_three, records as fixture_records, write_tree

PKGS = {"port": (audio_segments, chunked, dataset_process, hf_dataset, Segment),
        "jax": (j_audio, j_chunked, j_dp, j_hf, JSegment)}


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _strip(value, *roots):
    """``value`` (nested) with the directory roots replaced, to compare
    outputs the two packages wrote under different directories."""
    if isinstance(value, str):
        for i, root in enumerate(roots):
            value = value.replace(str(root), f"<root{i}>")
        return value
    if isinstance(value, dict):
        return {k: _strip(v, *roots) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_strip(v, *roots) for v in value)
    return value


@pytest.fixture()
def source_wav(tmp_path):
    sr = 16000
    t = np.arange(sr * 5) / sr
    audio = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    path = str(tmp_path / "EN9999a.Headset-0.wav")
    wavfile.write(path, sr, (audio * 32767).astype(np.int16))
    return path


def test_torch_load_slice_write_wav(source_wav, tmp_path):
    audio = audio_segments.load_wav(source_wav)
    assert audio.dtype == np.float32 and len(audio) == 80000
    np.testing.assert_array_equal(audio, j_audio.load_wav(source_wav))
    clip = audio_segments.slice_segment(audio, 1.0, 2.5)
    assert len(clip) == 24000
    np.testing.assert_array_equal(clip, j_audio.slice_segment(audio, 1.0, 2.5))
    out = audio_segments.write_wav(str(tmp_path / "x.wav"), clip)
    ref = j_audio.write_wav(str(tmp_path / "jax.wav"), clip)
    assert _bytes(out) == _bytes(ref)
    np.testing.assert_allclose(audio_segments.load_wav(out), clip, atol=1e-3)


def test_torch_batch_segment_audio_bit_equal(source_wav, tmp_path):
    results = {}
    for name, (aud, _, _, _, seg) in PKGS.items():
        segs = [seg("EN9999a", "A", 0.5, 1.5, "hello"), seg("EN9999a", "A", 2.0, 4.2, "world"),
                seg("EN9999a", "A", 4.9, 9.0, "tail overrun"), seg("EN9999a", "A", 6.0, 7.0, "x")]
        results[name] = aud.batch_segment_audio(source_wav, segs, str(tmp_path / name))
    got, want = results["port"], results["jax"]
    assert [ok for ok, _ in got] == [ok for ok, _ in want] == [True, True, True, False]
    assert len(audio_segments.load_wav(got[0][1])) == 16000
    assert len(audio_segments.load_wav(got[2][1])) == int(0.1 * 16000)
    for (ok, g), (_, w) in zip(got, want):
        if ok:
            assert _bytes(g) == _bytes(w)


def test_torch_add_noise_and_align():
    rng = np.random.default_rng(0)
    clean = 0.5 * np.sin(2 * np.pi * 440 * np.arange(16000) / 16000).astype(np.float32)
    noise = rng.normal(0, 0.3, 8000).astype(np.float32)
    mixed = audio_segments.add_noise(clean, noise, 10, rng=np.random.default_rng(1))
    np.testing.assert_array_equal(mixed, j_audio.add_noise(clean, noise, 10,
                                                           rng=np.random.default_rng(1)))
    assert 0.03 < np.mean((mixed - clean) ** 2) / np.mean(clean ** 2) < 0.3
    a, v = audio_segments.align_audio_video_lengths(np.zeros((10, 4)), np.zeros((7, 2)))
    assert len(a) == len(v) == 7


def _flaky():
    calls = []

    def work(x):
        calls.append(x)
        if x == 7 and calls.count(7) == 1:
            raise RuntimeError("transient")
        return True, x * 2

    return calls, work


def _checkpoint(mod, ckdir):
    ck = mod.find_checkpoint(ckdir)
    return None if ck is None else (ck.chunk_index, ck.last_item_processed, ck.chunk_size,
                                    ck.completed_chunks, ck.stats)


def test_torch_process_in_chunks_resume(tmp_path):
    outs = {}
    for name, (_, ch, _, _, _) in PKGS.items():
        calls, work = _flaky()
        ckdir = str(tmp_path / name)
        out = ch.process_in_chunks(list(range(10)), work, ckdir, chunk_size=3, checkpoint_every=1)
        status = [ch.chunk_status(ckdir, i) for i in range(4)]
        calls.clear()
        out2 = ch.process_in_chunks(list(range(10)), work, ckdir, chunk_size=3)
        outs[name] = (out, status, list(calls), out2, _checkpoint(ch, ckdir))
    out, status, calls, out2, ck = outs["port"]
    assert out["n_ok"] == 9 and out["n_failed"] == 1
    assert status[0] is True and status[2] is False
    assert calls == [] and out2["resumed_from"] is not None
    assert outs["port"] == outs["jax"]


def test_torch_midchunk_resume_and_chunk_size_remap(tmp_path):
    for name, (_, ch, _, _, _) in PKGS.items():
        ckdir = str(tmp_path / name / "mid")
        ch.save_checkpoint(ckdir, ch.ChunkCheckpoint(chunk_index=1, last_item_processed=0))
        seen = []
        ch.process_in_chunks(list(range(9)), lambda x: (seen.append(x) or True, x), ckdir,
                             chunk_size=3)
        assert seen[0] == 4, name
        ckdir = str(tmp_path / name / "remap")
        ch.save_checkpoint(ckdir, ch.ChunkCheckpoint(chunk_index=2, last_item_processed=0,
                                                     chunk_size=3))
        seen = []
        out = ch.process_in_chunks(list(range(10)), lambda x: (seen.append(x) or True, x),
                                   ckdir, chunk_size=5)
        assert seen[0] == 5 and out["n_ok"] == 5, name
        ckdir = str(tmp_path / name / "same")
        ch.save_checkpoint(ckdir, ch.ChunkCheckpoint(chunk_index=1, last_item_processed=1,
                                                     chunk_size=3))
        seen = []
        ch.process_in_chunks(list(range(9)), lambda x: (seen.append(x) or True, x), ckdir,
                             chunk_size=3)
        assert seen[0] == 5, name
    for sub in ("mid", "remap", "same"):
        assert _checkpoint(chunked, str(tmp_path / "port" / sub)) == \
            _checkpoint(j_chunked, str(tmp_path / "jax" / sub))


def test_torch_multiprocessing_driver_guards_item_exceptions(tmp_path, monkeypatch):
    """One raising item becomes (False, error), both chunks checkpoint, as
    in JAX; the port's pool spawns its workers (none inherits a CUDA
    context)."""
    contexts = []
    real = mp.get_context
    monkeypatch.setattr(chunked.mp, "get_context",
                        lambda method=None: contexts.append(method) or real(method))
    ckdir = str(tmp_path / "ck_mp")
    out = chunked.process_chunks_with_multiprocessing(
        list(range(6)), boom_on_three, ckdir, chunk_size=3, num_workers=2)
    assert contexts == ["spawn"]
    want = j_chunked.process_chunks_with_multiprocessing(
        list(range(6)), boom_on_three, str(tmp_path / "jax"), chunk_size=3, num_workers=2)
    assert out == want
    assert out["n_ok"] == 5 and out["n_failed"] == 1
    ok, payload = out["results"][3]
    assert ok is False and "ValueError" in payload
    assert _checkpoint(chunked, ckdir) == _checkpoint(j_chunked, str(tmp_path / "jax"))


def test_torch_update_csv_with_results(tmp_path):
    results = {"b": {"lip_path": "/out/b.mp4", "ok": True}, "zz": {"ok": False}}
    for name, (_, ch, _, _, _) in PKGS.items():
        p = str(tmp_path / f"{name}.csv")
        pd.DataFrame({"id": ["a", "b", "c"], "x": [1, 2, 3]}).to_csv(p, index=False)
        assert ch.update_csv_with_results(p, results) == 1
    df = pd.read_csv(str(tmp_path / "port.csv"))
    assert df.loc[df.id == "b", "lip_path"].iloc[0] == "/out/b.mp4"
    assert pd.isna(df.loc[df.id == "a", "lip_path"].iloc[0])
    assert _bytes(str(tmp_path / "port.csv")) == _bytes(str(tmp_path / "jax.csv"))


@pytest.fixture()
def records(tmp_path, source_wav):
    recs = [{"id": f"seg{i}", "transcript": f"text {i}", "start": float(i),
             "end": float(i + 1), "duration": 1.0, "meeting_id": "EN9999a",
             "speaker_id": "A", "audio": source_wav} for i in range(5)]
    recs.append(dict(recs[0], id="missing", audio=str(tmp_path / "nope.wav")))
    return recs


def _rows(ds):
    return {c: ds[c] for c in ds.column_names}


def test_torch_filter_and_package_hf_with_column_union(records, tmp_path):
    kept, dropped = hf_dataset.filter_corrupted_records(records, check_videos=False)
    assert len(kept) == 5 and len(dropped) == 1
    assert (kept, dropped) == j_hf.filter_corrupted_records(records, check_videos=False)
    ds = hf_dataset.av_to_hf_dataset(records, str(tmp_path / "port"), check_videos=False)
    want = j_hf.av_to_hf_dataset(records, str(tmp_path / "jax"), check_videos=False)
    assert len(ds) == 5 and ds[0]["transcript"] == "text 0"
    assert "path" in ds[0]["audio"] or "bytes" in ds[0]["audio"]
    assert ds.features == want.features and _rows(ds) == _rows(want)
    assert _bytes(str(tmp_path / "port" / "corruption_report.json")) == \
        _bytes(str(tmp_path / "jax" / "corruption_report.json"))

    recs = [dict(r) for r in records[:3]]
    recs[2]["lip_video"] = recs[2]["audio"]  # a key on one record only
    ds = hf_dataset.av_to_hf_dataset(recs, str(tmp_path / "port_u"), check_videos=False)
    want = j_hf.av_to_hf_dataset(recs, str(tmp_path / "jax_u"), check_videos=False)
    assert "lip_video" in ds.column_names and len(ds) == 3
    assert ds.column_names == want.column_names and _rows(ds) == _rows(want)


def test_torch_sharded_layout_roundtrip(records, tmp_path):
    port_dir, jax_dir = tmp_path / "sharded", tmp_path / "jax_sharded"
    manifest = hf_dataset.av_to_hf_dataset_with_shards(records, str(port_dir), num_shards=3,
                                                       check_videos=False)
    want = j_hf.av_to_hf_dataset_with_shards(records, str(jax_dir), num_shards=3,
                                             check_videos=False)
    assert manifest["n_records"] == 5 and manifest["n_dropped"] == 1
    assert len(manifest["shards"]) == 3
    assert _strip(manifest, port_dir) == _strip(want, jax_dir)
    back = hf_dataset.load_sharded_records(str(port_dir))
    assert [r["id"] for r in back] == [f"seg{i}" for i in range(5)]  # in order
    assert back == j_hf.load_sharded_records(str(port_dir)) == records[:5]
    rows = list(csv.DictReader(open(manifest["csv"])))
    assert len(rows) == 5 and "shard" in rows[0]
    assert _bytes(manifest["csv"]) == _bytes(want["csv"])


def test_torch_split_dataset(tmp_path, records):
    recs = [dict(r) for r in records[:5]] * 4
    for i, r in enumerate(recs):
        r["id"] = f"r{i}"
    splits = hf_dataset.split_dataset(recs, seed=1)
    assert [len(splits[k]) for k in ("train", "val", "test")] == [14, 2, 4]
    assert splits == j_hf.split_dataset(recs, seed=1)
    on_disk = hf_dataset.split_dataset(recs, str(tmp_path / "splits"), seed=1)
    want = j_hf.split_dataset(recs, str(tmp_path / "jax_splits"), seed=1)
    assert os.path.isdir(str(tmp_path / "splits" / "test"))
    assert {k: _rows(v) for k, v in on_disk.items()} == {k: _rows(v) for k, v in want.items()}


def test_torch_push_backoff():
    for push in (hf_dataset.push_dataset_to_hub, j_hf.push_dataset_to_hub):
        attempts, sleeps = [], []

        def flaky():
            attempts.append(1)
            if len(attempts) < 3:
                raise RuntimeError("HTTP 429 too many requests")
            return "pushed"

        assert push(flaky, sleep=sleeps.append) == "pushed"
        assert sleeps == [2.0, 4.0]
        with pytest.raises(ValueError):
            push(lambda: (_ for _ in ()).throw(ValueError("fatal")), sleep=sleeps.append)


def _markers(path):
    pd.DataFrame({
        "meeting_id": ["M"] * 8,
        "speaker_id": ["A"] * 8,
        "word": ["<laugh>", "um", "uh", ".", "<laugh>", "word", "<laugh>", "huh"],
        "start_time": [1.0, 2.0, 3.0, 4.0, 5.0, np.nan, 1.001, 6.0],
        "end_time": [1.5, 2.4, 3.01, 4.5, 5.5, 7.0, 1.501, 6.5],
        "disfluency_type": ["laughter", "hesitation", "hesitation", "fluent", "laughter",
                            "fluent", "laughter", "uh/huh?"],
    }).to_csv(path, index=False)


def test_torch_marker_pipeline(tmp_path):
    path = str(tmp_path / "markers.csv")
    _markers(path)
    df = dataset_process.load_laughter_markers(path)
    assert len(df) == 6  # punctuation and NaN dropped
    pd.testing.assert_frame_equal(df, j_dp.load_laughter_markers(path))
    segs, skip = dataset_process.collect_marker_segments(df, min_duration=0.05)
    assert (segs, skip) == j_dp.collect_marker_segments(df, min_duration=0.05)
    assert skip["too_short"] == 1
    assert segs[0]["id"] == dataset_process.marker_segment_id("M", "A", 1.0, 1.5, "laughter")
    dup = [s["id"] for s in segs if s["id"].startswith("M-A-laughter-1.00")]
    assert len(dup) == 2 and dup[1].endswith("-2")  # deduplicated
    assert dataset_process.sanitize_filename('uh/huh?*"x"') == "uh_huh___x_"
    sid = dataset_process.marker_segment_id("M", "A", 1.0, 1.5, "uh-huh?")
    assert "?" not in sid and sid.startswith("M-A-uh-huh_")
    assert sid == j_dp.marker_segment_id("M", "A", 1.0, 1.5, "uh-huh?")
    balanced = dataset_process.balance_classes(segs)
    assert balanced == j_dp.balance_classes(segs)


def test_torch_process_marker_dataset_stats(tmp_path, source_wav):
    df = pd.DataFrame({
        "meeting_id": ["EN9999a"] * 5 + ["ZZ0000x"],
        "speaker_id": ["A"] * 4 + ["Q", "A"],
        "word": ["<laugh>", "um", "uh", "w", "w", "w"],
        "start_time": [1.0, 2.0, 3.0, 4.0, 1.0, 1.0],
        "end_time": [1.5, 2.4, 3.01, 4.5, 1.5, 1.5],
        "disfluency_type": ["laughter", "hesitation", "hesitation", "fluent", "fluent", "fluent"],
    })
    outs = {}
    for name, (_, _, dp, _, _) in PKGS.items():
        outs[name] = dp.process_marker_dataset(
            df, audio_sources={("EN9999a", "A"): source_wav},
            output_dir=str(tmp_path / name), min_duration=0.05, balance=False,
            speakers=["A", "B", "C", "D", "E"])
    out, want = outs["port"], outs["jax"]
    stats = out["stats"]
    assert stats["skipped"]["speaker_mapping"] == 1
    assert stats["skipped"]["too_short"] == 1
    assert stats["skipped"]["source_missing"] == 1
    assert stats["per_event_type"] == {"fluent": 1, "hesitation": 1, "laughter": 1}
    assert stats["audio_ok"] == 3 and "laughter" in out["segments"][0]["audio"]
    assert _strip(out, tmp_path / "port") == _strip(want, tmp_path / "jax")
    assert _bytes(out["stats_path"]) == _bytes(want["stats_path"])
    for g, w in zip(out["segments"], want["segments"]):
        assert _bytes(g["audio"]) == _bytes(w["audio"])


def test_torch_segment_sources_end_to_end(tmp_path, source_wav):
    tdir = tmp_path / "transcripts"
    tdir.mkdir()
    (tdir / "EN9999a-A.txt").write_text("[0.50-1.50] hello there\n[2.00-4.20] general kenobi\n")
    outs = {}
    for name, (_, _, dp, _, _) in PKGS.items():
        outs[name] = dp.segment_sources(
            str(tdir), audio_sources={("EN9999a", "A"): source_wav},
            output_dir=str(tmp_path / name), video_sources=None, extract_lips=False,
            package_hf=True)
    out, want = outs["port"], outs["jax"]
    assert out["stats"] == {"segments": 2, "audio_ok": 2, "video_ok": 0, "lip_ok": 0,
                            "alignment_issues": 0}
    assert len(out["dataset"]) == 2
    assert _strip(out["records"], tmp_path / "port") == _strip(want["records"], tmp_path / "jax")
    assert out["stats"] == want["stats"] and out["issues"] == want["issues"]
    assert out["dataset"].column_names == want["dataset"].column_names
    recs, issues = dataset_process.create_dataset_records(
        [Segment("EN9999a", "A", 0.5, 1.5, "hello there")],
        str(tmp_path / "port" / "audio_segments"))
    assert issues == []


def test_torch_ami_segments_csv_loader(tmp_path, source_wav):
    csv_path = str(tmp_path / "ami-segments-info.csv")
    pd.DataFrame({"segment_id": ["s0", "s1"], "transcript": ["hello", "world"],
                  "duration": [1.0, 2.0], "audio_abs": [source_wav, source_wav],
                  "meeting_id": ["M", "M"], "speaker_id": ["A", "B"]}).to_csv(csv_path, index=False)
    recs = dataset_process.load_ami_segments_csv(csv_path)
    assert recs[0]["audio"] == source_wav and recs[0]["id"] == "s0"
    assert recs == j_dp.load_ami_segments_csv(csv_path)
    assert dataset_process.group_segments_by_source(recs) == j_dp.group_segments_by_source(recs)
    ds = dataset_process.process_ami_segments_dataset(csv_path, str(tmp_path / "hf_out"),
                                                      check_videos=False)
    want = j_dp.process_ami_segments_dataset(csv_path, str(tmp_path / "jax_out"),
                                             check_videos=False)
    assert len(ds) == 2 and _rows(ds) == _rows(want)


def test_torch_dataset_from_existing_segments(tmp_path):
    src = tmp_path / "src"
    (src / "audio_segments").mkdir(parents=True)
    (src / "video_segments").mkdir()
    tdir = tmp_path / "transcripts"
    tdir.mkdir()
    (tdir / "EN9999a-A.txt").write_text("[0.50-1.50] hello there\n")
    (src / "audio_segments" / "EN9999a-A-0.50-1.50.wav").write_bytes(b"x")
    (src / "audio_segments" / "EN9999a-A-2.00-3.00-audio.wav").write_bytes(b"x")
    (src / "audio_segments" / "stray.wav").write_bytes(b"x")
    (src / "video_segments" / "EN9999a-A-0.50-1.50-video.mp4").write_bytes(b"x")
    out = dataset_process.dataset_from_existing_segments(str(src), str(tdir),
                                                         str(tmp_path / "ds"), package_hf=False)
    want = j_dp.dataset_from_existing_segments(str(src), str(tdir), str(tmp_path / "jax_ds"),
                                               package_hf=False)
    by_id = {r["id"]: r for r in out["records"]}
    assert set(by_id) == {"EN9999a-A-0.50-1.50", "EN9999a-A-2.00-3.00"}
    r = by_id["EN9999a-A-0.50-1.50"]
    assert r["has_audio"] and r["has_video"] and r["has_transcript"]
    r2 = by_id["EN9999a-A-2.00-3.00"]
    assert r2["has_audio"] and not r2["has_video"] and not r2["has_transcript"]
    assert out == want and out["stats"]["skipped_bad_ids"] == 1
    assert _bytes(str(tmp_path / "ds" / "dataset_records.json")) == \
        _bytes(str(tmp_path / "jax_ds" / "dataset_records.json"))


def test_torch_reprocess_lips_from_csv(tmp_path, monkeypatch):
    """A rendered face clip's lip crop, the port's warp on the CPU against
    JAX's (crops captured before the mp4 encode), a missing file counted,
    the results JSON and the CSV merge as JAX writes them."""
    from avsl_tpu.data import lip_refine as jr
    from avsl_tpu.data import lip_roi as jroi
    from avsl_tpu.data import video_io as j_vio
    from avsl_tpu_torch.data import video_io
    from torch_lip_fixtures import assert_crops_match, face_clip

    frames, _ = face_clip(t=20)
    vid = str(tmp_path / "seg1.mp4")
    video_io.write_video_frames(vid, frames, fps=25)
    crops = {}
    for name, mod in (("port", video_io), ("jax", j_vio)):
        real = mod.write_video_frames
        monkeypatch.setattr(mod, "write_video_frames",
                            lambda p, f, fps=25, _n=name, _r=real: crops.setdefault(_n, f)
                            is not None and _r(p, f, fps))
    outs = {}
    for name, (_, _, dp, _, _) in PKGS.items():
        csv_path = str(tmp_path / f"{name}.csv")
        pd.DataFrame({"id": ["seg1", "seg2"], "video": [vid, str(tmp_path / "missing.mp4")],
                      "has_video": [True, True]}).to_csv(csv_path, index=False)
        kw = {"device": "cpu"} if name == "port" else {}
        outs[name] = dp.reprocess_lips_from_csv(csv_path, str(tmp_path / f"lips_{name}"), **kw)
    out, want = outs["port"], outs["jax"]
    assert out["missing_files"] == want["missing_files"] == 1
    assert out["n_ok"] == want["n_ok"] == 1
    decoded = j_vio.read_video_frames(vid, grayscale=True, max_frames=300)
    lms = jroi.smooth_landmarks(jroi.landmarks_interpolate(jr.RefinedMouthTracker()(decoded)), 12)
    assert crops["port"].shape == crops["jax"].shape == (len(frames), 96, 96)
    assert_crops_match(crops["port"].astype(np.float32), crops["jax"].astype(np.float32), lms, 1.0)
    df, jdf = pd.read_csv(str(tmp_path / "port.csv")), pd.read_csv(str(tmp_path / "jax.csv"))
    assert bool(df.loc[df.id == "seg1", "has_lip_video"].iloc[0])
    pd.testing.assert_frame_equal(df.drop(columns="lip_video"), jdf.drop(columns="lip_video"))
    results = json.load(open(str(tmp_path / "lips_port" / "lip_segment_results.json")))
    assert list(results) == ["seg1"] and results["seg1"]["success"]


def test_torch_dataset_fixture_writer_matches_jax(tmp_path):
    """``tests/torch_dataset_fixtures.py`` writes its trees with the port's
    ``av_to_hf_dataset``; the JAX writer gives the same columns and rows."""
    import datasets

    write_tree(tmp_path / "port", {"train": 3})
    recs = fixture_records(str(tmp_path / "jax" / "wavs"), 3, 0,
                           0.3 + 0.05 * np.arange(3), prefix="train")
    j_hf.av_to_hf_dataset(recs, str(tmp_path / "jax" / "train"), check_videos=False)
    got = datasets.load_from_disk(str(tmp_path / "port" / "train"))
    want = datasets.load_from_disk(str(tmp_path / "jax" / "train"))
    assert got.column_names == want.column_names and got.features == want.features
    for g, w in zip(got, want):
        assert g["audio"]["bytes"] == w["audio"]["bytes"]
        assert {k: v for k, v in g.items() if k != "audio"} == \
            {k: v for k, v in w.items() if k != "audio"}


@pytest.mark.parametrize("native", [True, False], ids=["native_or_cv2", "cv2"])
def test_torch_batch_segment_video_matches_jax(tmp_path, monkeypatch, native):
    """Clips cut from one closeup equal the JAX package's frame for frame,
    through the native decoder where it loads and through OpenCV's frame
    seek without it; a window past the end succeeds or fails as in JAX
    (OpenCV decodes no frame there and fails it)."""
    from avsl_tpu.data import media_native as j_mn
    from avsl_tpu.data import video_segments as j_vs
    from avsl_tpu_torch.data import media_native as mn
    from avsl_tpu_torch.data import video_segments
    from avsl_tpu_torch.data.video_io import read_video_frames, write_video_frames

    if not native:
        monkeypatch.setattr(mn, "_load_lib", lambda: None)
        monkeypatch.setattr(j_mn, "_load_lib", lambda: None)
    rng = np.random.default_rng(3)
    src = str(tmp_path / "X.Closeup1.mp4")
    write_video_frames(src, rng.integers(0, 256, (50, 64, 80), dtype=np.uint8), fps=25)
    results = {}
    for name, seg_cls, mod in (("port", Segment, video_segments), ("jax", JSegment, j_vs)):
        segs = [seg_cls("X", "A", 0.2, 0.9, "a"), seg_cls("X", "A", 1.0, 1.96, "b"),
                seg_cls("X", "A", 5.0, 6.0, "past the end")]
        results[name] = mod.batch_segment_video(src, segs, str(tmp_path / name))
    got, want = results["port"], results["jax"]
    assert [ok for ok, _ in got] == [ok for ok, _ in want]
    assert [ok for ok, _ in got][:2] == [True, True]
    if not native:
        assert not got[2][0]
    np.testing.assert_array_equal(video_segments.cut_segment_frames(src, 0.2, 0.9),
                                  j_vs.cut_segment_frames(src, 0.2, 0.9))
    for (_, g), (_, w) in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(read_video_frames(g, grayscale=True),
                                      read_video_frames(w, grayscale=True))
    if got[2][0]:  # the past-the-end window: the same degenerate file as JAX's
        assert _bytes(got[2][1]) == _bytes(want[2][1])
