"""Live streaming transcription: PCM chunks in, finalised utterances out.

Port of ``avsl_tpu/infer/streaming.py``. A :class:`StreamingSession` takes
PCM chunks of any size as they arrive, endpoints utterances at trailing
pauses by frame RMS (the long-form splitter's 25 ms frames) and hands each
finalised utterance to the transcriber as an ordinary batch item. The
device never sees a partial utterance. By default a session calls the
transcriber's ``transcribe_batch`` (one stream); many streams pass a
``transcribe_fn`` that submits through a ``TranscriptionServer``, whose
scheduler thread then stays the only client of the device and batches
utterances of different streams together::

    def via_server(items):
        pendings = [server.submit(it) for it in items]
        for p in pendings:
            p.done.wait(300)
        return [p.result for p in pendings]

    sess = StreamingSession(tr, transcribe_fn=via_server)

An utterance longer than the model window is force-cut at the quietest
frame of the window's last quarter, as the long-form splitter cuts.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from avsl_tpu_torch.infer.longform import LongSegment, shift_words


class StreamingSession:
    """Endpointing state machine for one audio stream.

    ``feed(pcm)`` buffers samples and returns the utterances this chunk
    finalised; ``flush()`` finalises the rest and closes the session.
    Segment times count from the first sample fed. An utterance finalises
    once it holds speech followed by ``min_silence_s`` of frames below
    ``silence_rms``; leading silence is skipped; a buffer that reaches the
    transcriber's ``audio_max_length`` is force-cut inside the window.
    """

    def __init__(
        self,
        transcriber,
        silence_rms: float = 5e-3,
        min_silence_s: float = 0.35,
        min_speech_s: float = 0.2,
        sample_rate: int = 16000,
        frame_ms: float = 25.0,
        stream_id: str = "stream",
        transcribe_fn=None,
    ):
        self._transcribe = (transcribe_fn if transcribe_fn is not None
                            else transcriber.transcribe_batch)
        self.sr = int(sample_rate)
        self.frame = max(int(self.sr * frame_ms / 1000.0), 1)
        self.silence_rms = float(silence_rms)
        self.min_silence_frames = max(int(round(min_silence_s * self.sr / self.frame)), 1)
        self.min_speech_samples = int(min_speech_s * self.sr)
        self.stream_id = stream_id
        self.max_samples = int(transcriber.audio_max_length)

        self._buf = np.zeros((0,), np.float32)
        self._origin = 0  # the stream's sample index of _buf[0]
        self._n_segments = 0
        self._closed = False

    # -- host-side endpointing ------------------------------------------

    def _frame_rms(self, x: np.ndarray) -> np.ndarray:
        k = (len(x) // self.frame) * self.frame
        if k == 0:
            return np.zeros((0,), np.float32)
        return np.sqrt(np.mean(x[:k].reshape(-1, self.frame) ** 2, axis=1))

    def _skip_leading_silence(self) -> None:
        rms = self._frame_rms(self._buf)
        speech = np.nonzero(rms >= self.silence_rms)[0]
        if speech.size:
            cut = int(speech[0]) * self.frame
        else:  # all silence: keep only a tail that may hold an onset
            cut = max(len(self._buf) - self.frame * self.min_silence_frames, 0)
            cut = (cut // self.frame) * self.frame
        if cut:
            self._buf = self._buf[cut:]
            self._origin += cut

    def _endpoint(self) -> Optional[int]:
        """Sample index (exclusive) at which the buffer finalises, or None
        while the utterance is open."""
        rms = self._frame_rms(self._buf)
        if rms.size < self.min_silence_frames + 1:
            return None
        voiced = rms >= self.silence_rms
        if not voiced.any() or voiced[-self.min_silence_frames:].any():
            return None
        end = (int(np.nonzero(voiced)[0][-1]) + 1) * self.frame
        if end < self.min_speech_samples:
            return None
        # half the pause goes with this utterance, so the next starts inside it
        return min(end + (self.min_silence_frames // 2) * self.frame, len(self._buf))

    def _force_cut_point(self) -> int:
        """Centre of the quietest frame in the window's last quarter, never
        past ``max_samples``."""
        window = min(len(self._buf), self.max_samples)
        lo = (3 * window // 4 // self.frame) * self.frame
        rms = self._frame_rms(self._buf[lo:window])
        if rms.size == 0:
            return window
        return min(lo + int(np.argmin(rms)) * self.frame + self.frame // 2, window)

    def _finalize(self, end: int) -> LongSegment:
        utt = self._buf[:end]
        start = self._origin
        self._buf = self._buf[end:]
        self._origin += end
        r = self._transcribe([{"id": f"{self.stream_id}#s{self._n_segments}", "audio": utt}])[0]
        self._n_segments += 1
        return LongSegment(
            start_s=round(start / self.sr, 3),
            end_s=round((start + end) / self.sr, 3),
            text=r.text,
            avg_logprob=r.avg_logprob,
            words=shift_words(getattr(r, "words", None), start / self.sr),
        )

    # -- public API ------------------------------------------------------

    def feed(self, pcm: np.ndarray) -> List[LongSegment]:
        """Append a chunk (float32 PCM at the session's rate); returns the
        utterances it finalised, in order."""
        if self._closed:
            raise RuntimeError("session is flushed/closed")
        self._buf = np.concatenate([self._buf, np.asarray(pcm, np.float32).ravel()])
        out: List[LongSegment] = []
        while True:
            self._skip_leading_silence()
            end = self._endpoint()
            if (end is None or end > self.max_samples) and len(self._buf) >= self.max_samples:
                # cut inside the window, or the transcriber would drop the
                # speech past it while the segment claims the whole span
                end = self._force_cut_point()
            if end is None or end == 0:
                break
            out.append(self._finalize(end))
        return out

    def flush(self) -> List[LongSegment]:
        """Finalise whatever speech remains and close the session."""
        self._closed = True
        self._skip_leading_silence()
        out: List[LongSegment] = []
        while len(self._buf) >= self.max_samples:
            out.append(self._finalize(self._force_cut_point()))
        rms = self._frame_rms(self._buf)
        if (rms >= self.silence_rms).any():
            last = int(np.nonzero(rms >= self.silence_rms)[0][-1])
            end = min((last + 1) * self.frame, len(self._buf))
            if end >= self.min_speech_samples:
                out.append(self._finalize(end))
        self._buf = np.zeros((0,), np.float32)
        return out
