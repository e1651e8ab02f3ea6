"""The port's preprocessing CLI (CPU): the cases of ``tests/test_cli.py``
for ``avsl_tpu.cli.preprocess``, through ``avsl_tpu_torch.cli.preprocess``.

* ``python -m avsl_tpu_torch.cli.preprocess`` in a subprocess runs the
  annotation subcommands (``transcripts``, ``markers``, ``dialogue_acts``)
  and ``segment --no_lips``; that subprocess never imports ``avsl_tpu`` or
  ``jax`` (its ``sys.modules`` is read back), and what it writes is
  byte-identical to the JAX CLI's output on the same tree;
* in process, ``segment_exist``, ``reprocess_lips`` and ``marker_dataset``
  print JAX's statistics (``reprocess_lips --device cpu`` runs the lip
  warp on the CPU), and ``lips --device cpu`` crops a directory of clips
  with chunked resume.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import scipy.io.wavfile as wavfile

from avsl_tpu.cli.preprocess import main as jax_main
from avsl_tpu_torch.cli.preprocess import main as pp_main
from avsl_tpu_torch.data.video_io import write_video_frames
from test_data_ami import DISFLUENCY_XML, DSFL_TYPES_XML, SEGMENTS_XML, WORDS_XML
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN_MODULE = """
import json, runpy, sys
sys.argv = ["preprocess"] + json.loads(sys.argv[1])
try:
    runpy.run_module("avsl_tpu_torch.cli.preprocess", run_name="__main__")
finally:
    print("MODULES " + json.dumps(sorted(m for m in sys.modules
                                          if m.split(".")[0] in ("jax", "avsl_tpu", "flax"))))
"""


def _subprocess(args):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", RUN_MODULE, json.dumps(args)],
                         capture_output=True, text=True, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-800:]
    line = [x for x in out.stdout.splitlines() if x.startswith("MODULES ")][-1]
    assert json.loads(line[len("MODULES "):]) == []
    return out.stdout


def _tree(root):
    for sub in ("words", "segments", "disfluency", "ontologies"):
        (root / sub).mkdir(parents=True)
    (root / "words" / "EN2001a.A.words.xml").write_text(WORDS_XML)
    (root / "segments" / "EN2001a.A.segments.xml").write_text(SEGMENTS_XML)
    (root / "disfluency" / "EN2001a.A.disfluency.xml").write_text(DISFLUENCY_XML)
    (root / "ontologies" / "dsfl-types.xml").write_text(DSFL_TYPES_XML)
    return root


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n


def test_torch_preprocess_cli_subprocess(tmp_path, capsys):
    """The JAX test's one-word tree through ``python -m``, then the
    annotation subcommands and ``segment --no_lips`` on the AMI test tree,
    each against the JAX CLI's files."""
    tdir = tmp_path / "transcripts"
    (tdir / "words").mkdir(parents=True)
    (tdir / "segments").mkdir()
    (tdir / "words" / "X.A.words.xml").write_text(
        '<?xml version="1.0"?>\n'
        '<nite:root xmlns:nite="http://nite.sourceforge.net/">\n'
        '<w nite:id="X.A.words0" starttime="0.5" endtime="0.9">hey</w>\n'
        "</nite:root>\n")
    (tdir / "segments" / "X.A.segments.xml").write_text(
        '<?xml version="1.0"?>\n'
        '<nite:root xmlns:nite="http://nite.sourceforge.net/">\n'
        '<segment transcriber_start="0.5" transcriber_end="0.9">\n'
        '<nite:child href="X.A.words.xml#id(X.A.words0)"/>\n'
        "</segment></nite:root>\n")
    _subprocess(["transcripts", "--input", str(tdir), "--output", str(tmp_path / "txt")])
    assert (tmp_path / "txt" / "X-A.txt").read_text().strip() == "[0.5-0.9] hey"

    ami = _tree(tmp_path / "ami")
    onto = ["--disfluency_dir", str(ami / "disfluency"),
            "--dsfl_types", str(ami / "ontologies" / "dsfl-types.xml")]
    runs = [["transcripts", "--input", str(ami)],
            ["markers", "--input", str(ami), *onto],
            ["markers", "--input", str(ami), "--strict_reference", *onto],
            ["dialogue_acts", "--input", str(ami)]]
    for i, args in enumerate(runs):
        _subprocess(args + ["--output", str(tmp_path / f"port{i}")])
        jax_main(args + ["--output", str(tmp_path / f"jax{i}")])
        _same_tree(tmp_path / f"port{i}", tmp_path / f"jax{i}")
    capsys.readouterr()

    media = tmp_path / "media"
    media.mkdir()
    rng = np.random.default_rng(0)
    wavfile.write(str(media / "EN2001a.Headset-0.wav"), 16000,
                  (0.2 * rng.standard_normal(5 * 16000) * 32767).astype(np.int16))
    seg = ["segment", "--transcripts", str(tmp_path / "port0"), "--media_dir", str(media),
           "--no_lips"]
    port_out = _subprocess(seg + ["--output", str(tmp_path / "seg_port")])
    stats = json.loads(port_out[:port_out.index("MODULES ")])
    assert stats["segments"] == 2 and stats["audio_ok"] == 2 and stats["alignment_issues"] == 0
    jax_main(seg + ["--output", str(tmp_path / "seg_jax")])
    assert json.loads(capsys.readouterr().out) == stats
    _same_tree(tmp_path / "seg_port" / "audio_segments", tmp_path / "seg_jax" / "audio_segments")


def test_torch_preprocess_new_modes_cli(tmp_path, capsys):
    src = tmp_path / "src"
    (src / "audio_segments").mkdir(parents=True)
    (src / "video_segments").mkdir()
    tdir = tmp_path / "transcripts"
    tdir.mkdir()
    (tdir / "EN9999a-A.txt").write_text("[0.50-1.50] hello there\n")
    (src / "audio_segments" / "EN9999a-A-0.50-1.50.wav").write_bytes(b"x")
    (src / "audio_segments" / "stray-notes.wav").write_bytes(b"x")
    args = ["segment_exist", "--source_dir", str(src), "--transcripts", str(tdir),
            "--no_dataset"]
    pp_main(args + ["--output", str(tmp_path / "ds")])
    stats = json.loads(capsys.readouterr().out)
    assert stats["records"] == 1 and stats["skipped_bad_ids"] == 1
    assert (tmp_path / "ds" / "dataset_records.json").exists()
    jax_main(args + ["--output", str(tmp_path / "jax_ds")])
    assert json.loads(capsys.readouterr().out) == stats

    vid = str(tmp_path / "seg1.mp4")
    write_video_frames(vid, np.random.default_rng(0).integers(0, 255, (6, 120, 160))
                       .astype(np.uint8), fps=25)
    for name, main, extra in (("port", pp_main, ["--device", "cpu"]), ("jax", jax_main, [])):
        csv_path = str(tmp_path / f"{name}.csv")
        pd.DataFrame({"id": ["seg1"], "video": [vid]}).to_csv(csv_path, index=False)
        main(["reprocess_lips", "--csv", csv_path, "--output", str(tmp_path / f"lips_{name}"),
              *extra])
        rep = json.loads(capsys.readouterr().out)
        assert rep["n_ok"] + rep["n_failed"] == 1
        assert "has_lip_video" in pd.read_csv(csv_path).columns
        if name == "port":
            port_rep = rep
    assert rep == port_rep

    media = tmp_path / "media"
    media.mkdir()
    sr = 16000
    wavfile.write(str(media / "EN9999a.Headset-0.wav"), sr,
                  (np.sin(np.arange(3 * sr) * 0.05) * 20000).astype(np.int16))
    mcsv = str(tmp_path / "markers.csv")
    pd.DataFrame({"meeting_id": ["EN9999a", "EN9999a"], "speaker_id": ["A", "A"],
                  "word": ["<laugh>", "um"], "start_time": [0.5, 1.0], "end_time": [1.0, 1.4],
                  "disfluency_type": ["laughter", "hesitation"]}).to_csv(mcsv, index=False)
    args = ["marker_dataset", "--csv", mcsv, "--media_dir", str(media), "--check_speakers",
            "--no_balance"]
    pp_main(args + ["--output", str(tmp_path / "marker_out")])
    mstats = json.loads(capsys.readouterr().out)
    assert mstats["audio_ok"] == 2
    assert mstats["per_event_type"] == {"hesitation": 1, "laughter": 1}
    assert (tmp_path / "marker_out" / "marker_dataset_stats.json").exists()
    jax_main(args + ["--output", str(tmp_path / "jax_marker_out")])
    assert json.loads(capsys.readouterr().out) == mstats


def test_torch_preprocess_lips_dir_with_resume(tmp_path, capsys):
    """``lips --device cpu`` over a directory of face clips: every clip
    cropped to a 96 x 96 ``-lip.mp4``; a rerun resumes past them."""
    from torch_lip_fixtures import face_clip

    vids = tmp_path / "vids"
    vids.mkdir()
    for i in range(2):
        write_video_frames(str(vids / f"s{i}.mp4"), face_clip(t=12, seed=i)[0], fps=25)
    args = ["lips", "--input", str(vids), "--output", str(tmp_path / "lips"),
            "--chunk_size", "1", "--device", "cpu"]
    pp_main(args)
    out = json.loads(capsys.readouterr().out)
    assert out == {"n_ok": 2, "n_failed": 0, "resumed_from": None}
    from avsl_tpu_torch.data.video_io import read_video_frames

    for i in range(2):
        clip = read_video_frames(str(tmp_path / "lips" / f"s{i}-lip.mp4"), grayscale=True)
        assert clip.shape == (12, 96, 96)
    pp_main(args)
    again = json.loads(capsys.readouterr().out)
    assert again["n_ok"] == 0 and again["resumed_from"] == [2, 0]
