"""The port's AMI annotation layer against the JAX package's (CPU).

The seven AMI cases of ``tests/test_data_ami.py`` on the same synthetic
NITE-XML tree: each holds the port to that test's assertions, and the
port and JAX write byte-identical transcript txt and CSV files and give
equal words, ontologies and ``Segment`` lists.
"""

import csv
import dataclasses


from avsl_tpu.data import ami_xml as jax_ami
from avsl_tpu.data import segments as jax_segments
from avsl_tpu_torch.data import ami_xml, segments
from test_data_ami import AP_TYPES_XML, AP_XML, DA_TYPES_XML, DACT_XML
from test_data_ami import ami_tree  # noqa: F401 (fixture)


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


def test_torch_parse_words_file(ami_tree):  # noqa: F811
    path = str(ami_tree / "words" / "EN2001a.A.words.xml")
    words = ami_xml.parse_words_file(path)
    assert words["EN2001a.A.words0"].text == "Hello"
    assert words["EN2001a.A.words2"].is_punct
    assert words["EN2001a.A.words3"].text == "<laugh>"
    assert words["EN2001a.A.words4"].is_trunc
    assert words["EN2001a.A.words5"].tag == "disfmarker"
    want = jax_ami.parse_words_file(path)
    assert list(words) == list(want)
    assert [dataclasses.astuple(w) for w in words.values()] == \
        [dataclasses.astuple(w) for w in want.values()]


def test_torch_process_transcript_files(ami_tree, tmp_path):  # noqa: F811
    args = (str(ami_tree / "segments" / "EN2001a.A.segments.xml"),
            str(ami_tree / "words" / "EN2001a.A.words.xml"))
    out, ref = tmp_path / "EN2001a-A.txt", tmp_path / "jax.txt"
    n = ami_xml.process_transcript_files(*args, str(out))
    assert n == jax_ami.process_transcript_files(*args, str(ref)) == 2
    lines = out.read_text().strip().split("\n")
    assert lines[0] == "[1.00-2.10] Hello world. <laugh>"
    assert lines[1] == "[2.20-3.80] again um"
    _same_bytes(out, ref)
    # the directory walk writes the same files
    got = ami_xml.process_transcripts(str(ami_tree), str(tmp_path / "port"))
    want = jax_ami.process_transcripts(str(ami_tree), str(tmp_path / "jax"))
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want]
    for g, w in zip(got, want):
        _same_bytes(g, w)


def test_torch_collect_segments(ami_tree, tmp_path):  # noqa: F811
    out_dir = tmp_path / "txt"
    out_dir.mkdir()
    ami_xml.process_transcript_files(
        str(ami_tree / "segments" / "EN2001a.A.segments.xml"),
        str(ami_tree / "words" / "EN2001a.A.words.xml"),
        str(out_dir / "EN2001a-A.txt"),
    )
    segs = segments.collect_segments_from_transcripts(str(out_dir))
    assert len(segs) == 2
    s = segs[0]
    assert s.meeting_id == "EN2001a" and s.speaker_id == "A"
    assert s.audio_channel == "Headset-0" and s.video_channel == "Closeup1"
    assert s.segment_id == segments.segment_id("EN2001a", "A", 1.0, 2.1)
    assert segments.segment_id("EN2001a", "A", 1.0, 2.1) == \
        jax_segments.segment_id("EN2001a", "A", 1.0, 2.1)
    for kw in ({}, {"min_duration": 1.5}, {"max_duration": 1.2}):
        got = segments.collect_segments_from_transcripts(str(out_dir), **kw)
        want = jax_segments.collect_segments_from_transcripts(str(out_dir), **kw)
        assert [dataclasses.astuple(g) for g in got] == [dataclasses.astuple(w) for w in want]
    assert len(segments.collect_segments_from_transcripts(str(out_dir), min_duration=1.5)) == 1


def _both(fn_name, tmp_path, name, *args, **kwargs):
    got = getattr(ami_xml, fn_name)(*args[:1], str(tmp_path / f"port_{name}"), **kwargs)
    want = getattr(jax_ami, fn_name)(*args[:1], str(tmp_path / f"jax_{name}"), **kwargs)
    return got, want


def test_torch_disfluency_csv(ami_tree, tmp_path):  # noqa: F811
    onto = dict(disfluency_dir=str(ami_tree / "disfluency"),
                dsfl_types_file=str(ami_tree / "ontologies" / "dsfl-types.xml"))
    path, ref = _both("disfluency_laughter_to_csv", tmp_path, "out", str(ami_tree), **onto)
    rows = list(csv.DictReader(open(path)))
    types = {(r["word"], r["disfluency_type"]) for r in rows}
    assert ("<laugh>", "laughter") in types
    assert ("um", "hesitation") in types
    assert not any(r["disfluency_type"] == "fluent" for r in rows)
    _same_bytes(path, ref)

    path2, ref2 = _both("disfluency_laughter_to_csv", tmp_path, "out2", str(ami_tree))
    rows2 = list(csv.DictReader(open(path2)))
    assert any(r["disfluency_type"] == "fluent" for r in rows2)
    assert any(r["disfluency_type"] == "laughter" for r in rows2)
    _same_bytes(path2, ref2)
    path3, ref3 = _both("disfluency_laughter_to_csv", tmp_path, "fluent", str(ami_tree),
                        include_fluent=True, **onto)
    _same_bytes(path3, ref3)


def test_torch_disfluency_csv_strict_reference(ami_tree, tmp_path):  # noqa: F811
    onto = dict(disfluency_dir=str(ami_tree / "disfluency"),
                dsfl_types_file=str(ami_tree / "ontologies" / "dsfl-types.xml"))
    path, ref = _both("disfluency_laughter_to_csv", tmp_path, "strict", str(ami_tree),
                      strict_reference=True, **onto)
    rows = [tuple(r) for r in csv.reader(open(path))][1:]
    assert rows == [("EN2001a", "A", "um", "3.20", "3.80", "hesitation")]
    _same_bytes(path, ref)

    path2, ref2 = _both("disfluency_laughter_to_csv", tmp_path, "strict2", str(ami_tree),
                        strict_reference=True)
    rows2 = [tuple(r) for r in csv.reader(open(path2))][1:]
    assert rows2 == [
        ("EN2001a", "A", "Hello", "1.00", "1.30", "fluent"),
        ("EN2001a", "A", "world", "1.30", "1.60", "fluent"),
        ("EN2001a", "A", ".", "", "", "fluent"),
        ("EN2001a", "A", "<laugh>", "1.70", "2.10", "laughter"),
        ("EN2001a", "A", "wor-", "2.20", "2.40", "fluent"),
        ("EN2001a", "A", "again", "2.50", "2.90", "fluent"),
        ("EN2001a", "A", "um", "3.20", "3.80", "fluent"),
    ]
    _same_bytes(path2, ref2)

    path3, ref3 = _both("disfluency_laughter_to_csv", tmp_path, "default", str(ami_tree), **onto)
    rows3 = [tuple(r) for r in csv.reader(open(path3))][1:]
    assert ("EN2001a", "A", "<laugh>", "1.70", "2.10", "laughter") in rows3
    _same_bytes(path3, ref3)


def test_torch_load_disfluency_types(ami_tree):  # noqa: F811
    path = str(ami_tree / "ontologies" / "dsfl-types.xml")
    types = ami_xml.load_disfluency_types(path)
    assert types == {"ami_dsfl_0": "hesitation", "ami_dsfl_1": "repetition"}
    assert types == jax_ami.load_disfluency_types(path)


def test_torch_dialogue_acts_csv(ami_tree, tmp_path):  # noqa: F811
    da_dir = ami_tree / "dialogueActs"
    da_dir.mkdir()
    (da_dir / "EN2001a.A.dialog-act.xml").write_text(DACT_XML)
    (da_dir / "EN2001a.adjacency-pairs.xml").write_text(AP_XML)
    (ami_tree / "ontologies" / "da-types.xml").write_text(DA_TYPES_XML)
    (ami_tree / "ontologies" / "ap-types.xml").write_text(AP_TYPES_XML)
    kw = dict(da_types_file=str(ami_tree / "ontologies" / "da-types.xml"),
              ap_types_file=str(ami_tree / "ontologies" / "ap-types.xml"))
    out, ref = _both("dialogue_acts_to_csv", tmp_path, "da_out", str(ami_tree), **kw)

    da_rows = list(csv.DictReader(open(out["dialogue_acts"])))
    assert len(da_rows) == 2
    assert da_rows[0]["dialogue_act_type"] == "inform"
    assert da_rows[0]["dialogue_act_category"] == "info"
    assert da_rows[0]["event_type"] == "fluent"
    ap_rows = list(csv.DictReader(open(out["adjacency_pairs"])))
    assert ap_rows[0]["pair_type_gloss"] == "positive"
    assert ap_rows[0]["source_speaker_id"] == "A"
    assert ap_rows[0]["target_dact_id"] == "EN2001a.B.dact.7"
    joined_rows = list(csv.DictReader(open(out["joined"])))
    assert [r for r in joined_rows if r.get("pair_id")]
    assert sorted(out) == sorted(ref)
    for key in out:
        _same_bytes(out[key], ref[key])
