"""Long-form transcription of the port (infer/longform.py and
``StreamingTranscriber.transcribe_long``) against the JAX package (CPU).

``energy_cut_points`` gives JAX's spans on speech with pauses (every
interior cut inside a pause), on pure silence, on short audio and on
noise; ``split_item`` gives JAX's windows, the lip clip's frames sliced in
sync; ``stitch`` JAX's result; and ``transcribe_long`` on the tiny
Whisper-Flamingo model JAX's segments, texts and words, equal to serving
the windows by hand.
"""

import numpy as np
import pytest

from avsl_tpu.infer import TranscribeResult as JaxResult
from avsl_tpu.infer import longform as jax_longform
from avsl_tpu_torch.data.video_io import write_video_frames
from avsl_tpu_torch.infer import TranscribeResult, longform
from test_torch_flamingo_common import one_torch_thread  # noqa: F401
from torch_serving_fixtures import SR, carried_models, speech_with_pauses, transcriber_pair

SIGNALS = {
    "pauses": (speech_with_pauses()[0], int(SR * 2.0), 1.0),
    "pauses_default_search": (speech_with_pauses(6, 1.2, 0.4, seed=1)[0], int(SR * 3.0), 2.0),
    "silence": (np.zeros(10 * SR, np.float32), SR, 2.0),
    "short": (np.zeros(SR, np.float32), 4 * SR, 2.0),
    "noise": (np.random.default_rng(2).standard_normal(7 * SR).astype(np.float32), 16000, 0.5),
    "tiny_window": (np.random.default_rng(3).standard_normal(300).astype(np.float32), 50, 2.0),
}


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_torch_energy_cut_points_match_jax(name):
    audio, window, search = SIGNALS[name]
    want = jax_longform.energy_cut_points(audio, window, search_s=search)
    got = longform.energy_cut_points(audio, window, search_s=search)
    assert got == want
    assert got[0][0] == 0 and got[-1][1] == len(audio)
    assert all(e0 == s1 for (_, e0), (s1, _) in zip(got, got[1:]))
    assert all(0 < e - s <= window for s, e in got)
    if name == "pauses":
        _, pauses = speech_with_pauses()
        assert len(got) > 1
        assert all(any(p0 <= e <= p1 for p0, p1 in pauses) for _, e in got[:-1])


def test_torch_split_item_matches_jax(tmp_path):
    audio, _ = speech_with_pauses(n_bursts=3)
    n_frames = int(round(len(audio) / SR * 25))
    frames = np.random.default_rng(1).integers(0, 255, (n_frames, 96, 96)).astype(np.uint8)
    lip = write_video_frames(str(tmp_path / "long-lip.mp4"), frames, fps=25)
    item = {"id": "av", "audio": audio, "lip_video": lip}
    want = jax_longform.split_item(item, int(SR * 1.5), video_frames=50)
    got = longform.split_item(item, int(SR * 1.5), video_frames=50)
    assert got[1] == want[1] and len(got[0]) == len(want[0]) >= 3
    for g, w in zip(got[0], want[0]):
        assert sorted(g) == sorted(w) == ["audio", "id", "lip_feats"]
        assert g["id"] == w["id"]
        np.testing.assert_array_equal(g["audio"], w["audio"])
        np.testing.assert_allclose(g["lip_feats"], w["lip_feats"], atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        longform.split_item({"audio": np.zeros(SR, np.float32), "video": "x.mp4"}, SR, 50)


def test_torch_stitch_matches_jax():
    rows = [("a#w0", "hello", False, [{"word": "hello", "start_s": 0.1, "end_s": 0.5}]),
            ("a#w1", "", True, None), ("a#w2", "world", False, [])]
    spans = [(0.0, 1.5), (1.5, 3.0), (3.0, 4.2)]
    want = jax_longform.stitch("a", [JaxResult(id=i, text=t, tokens=[], has_video=v, words=w)
                                     for i, t, v, w in rows], spans)
    got = longform.stitch("a", [TranscribeResult(id=i, text=t, tokens=[], has_video=v, words=w)
                                for i, t, v, w in rows], spans)
    assert (got.id, got.text, got.has_video) == (want.id, want.text, want.has_video) == \
        ("a", "hello world", True)
    assert [vars(s) for s in got.segments] == [vars(s) for s in want.segments]


def test_torch_transcribe_long_matches_jax():
    jtr, ptr = transcriber_pair(carried_models(av=True, seed=45), batch_size=4,
                                max_new_tokens=4, word_timestamps=True)
    a1, _ = speech_with_pauses(n_bursts=3, burst_s=0.8, pause_s=0.3)
    a2, _ = speech_with_pauses(n_bursts=2, burst_s=0.6, pause_s=0.2, seed=4)
    its = [{"id": "long1", "audio": a1}, {"id": "long2", "audio": a2}]
    want, got = jtr.transcribe_long(its), ptr.transcribe_long(its)
    for w, g in zip(want, got):
        assert (g.id, g.text, g.has_video) == (w.id, w.text, w.has_video)
        assert len(g.segments) == len(w.segments) >= 2
        for ws, gs in zip(w.segments, g.segments):
            assert (gs.start_s, gs.end_s, gs.text, gs.words) == \
                (ws.start_s, ws.end_s, ws.text, ws.words)
            assert abs(gs.avg_logprob - ws.avg_logprob) <= 1e-4
        assert g.segments[0].start_s == 0.0
    assert abs(got[0].segments[-1].end_s - len(a1) / SR) < 1e-3
    windows, _ = longform.split_item(its[0], ptr.audio_max_length, ptr.video_frames)
    manual = ptr.transcribe(windows)
    assert [s.text for s in got[0].segments] == [m.text for m in manual]
