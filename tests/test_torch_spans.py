"""The port's span recorder (``avsl_tpu_torch/utils/spans.py``) and its
sites in serving, training and the prefetcher.

The recorder off records nothing and hands out one shared object; on, it
records names, threads, parents and counters, and changes no result: a
transcribe call returns the same results and a train step leaves the same
parameters, to the bit, with recording on and off. The card test holds
the recorder's clock to the device trace's.
"""

import threading

import numpy as np
import pytest
import torch

from avsl_tpu_torch.utils import spans

MS = 1_000_000  # ns

SERVE_BATCH = ("serve.upload", "serve.encode", "serve.cache", "decode.prefill",
               "decode.sync", "decode.step", "serve.readback")


def test_torch_spans_off_record_nothing():
    off = spans.span("a")
    assert spans.span("b") is off
    with off:
        spans.count("h2d_bytes", 10)
    with spans.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}
    assert spans.span("c") is off


def test_torch_spans_on_record_parents_threads_and_counters():
    with spans.recording() as rec:
        with spans.span("outer"):
            with spans.span("inner"):
                spans.count("h2d_bytes", 5)
            with spans.span("second"):
                pass

        def other():
            with spans.span("other"):
                spans.count("h2d_bytes", 6)

        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        opened, blocker, done = threading.Event(), threading.Event(), threading.Event()

        def left_open():
            with spans.span("left_open"):
                opened.set()
                blocker.wait(timeout=30)
            done.set()

        t2 = threading.Thread(target=left_open)
        t2.start()
        assert opened.wait(timeout=30)
    blocker.set()
    t2.join(timeout=30)
    assert done.is_set()
    main = threading.get_ident()
    names = [s.name for s in rec.spans]
    assert names == ["outer", "inner", "second", "other", "left_open"]
    outer, inner, second, other, cut = rec.spans
    assert (outer.parent, inner.parent, second.parent, other.parent) == (-1, 0, 0, -1)
    assert outer.thread == inner.thread == main and other.thread != main
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= second.start_ns <= outer.end_ns
    # a span still open when the recording ends is cut there, and its late
    # exit writes nothing into the finished record
    assert cut.end_ns >= cut.start_ns and cut.end_ns <= outer.end_ns + 60 * 10 ** 9
    assert rec.counters == {"h2d_bytes": 11}


def test_torch_spans_recordings_do_not_nest():
    with spans.recording():
        with pytest.raises(RuntimeError, match="already open"):
            with spans.recording():
                pass
    with spans.recording() as rec:  # the failed nesting left nothing open
        with spans.span("a"):
            pass
    assert [s.name for s in rec.spans] == ["a"]


def test_torch_spans_current_is_the_open_recording():
    assert spans.current() is None
    with spans.recording() as rec:
        assert spans.current() is rec
    assert spans.current() is None


def test_torch_spans_entered_after_the_recording_record_nothing():
    """A span made while a recording is open but entered after it ended
    (a thread that outlives the block) leaves the finished record as it
    was, and spans on that thread later record in a new recording without
    a parent from the old one."""
    with spans.recording() as rec:
        with spans.span("kept"):
            pass
        late = spans.span("late")
    with late:
        with spans.recording() as again:
            with spans.span("next"):
                pass
    assert [s.name for s in rec.spans] == ["kept"] and rec.spans[0].end_ns >= 0
    assert [(s.name, s.parent) for s in again.spans] == [("next", -1)]


# -- serving ---------------------------------------------------------------


def _transcriber():
    from avsl_tpu_torch.data.tokenizer import ByteTokenizer
    from avsl_tpu_torch.infer import StreamingTranscriber
    from avsl_tpu_torch.models import build_whisper_flamingo

    vocab = ByteTokenizer().add_tokens(["<laugh>"])
    model, _ = build_whisper_flamingo("test", vocab_size=vocab, add_gated_x_attn=1,
                                      use_av_hubert_encoder=True, dtype="float32",
                                      device="cpu", seed=1)
    return StreamingTranscriber(model, ByteTokenizer(), audio_max_length=16000, video_frames=25,
                                batch_size=3, max_new_tokens=4)


def _serving_items(n=5):
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        item = {"id": f"u{i}", "audio": (0.2 * rng.standard_normal(9000)).astype(np.float32)}
        if i % 2 == 0:
            item["lip_feats"] = rng.standard_normal((20, 88, 88, 1)).astype(np.float32)
        out.append(item)
    return out


def test_torch_transcribe_records_serving_spans():
    tr = _transcriber()
    items = _serving_items()
    want = tr.transcribe(items)
    with spans.recording() as rec:
        got = tr.transcribe(items)
    assert [(r.id, r.tokens, r.avg_logprob) for r in got] == \
        [(r.id, r.tokens, r.avg_logprob) for r in want]
    main = threading.get_ident()
    prepare = [s for s in rec.spans if s.name == "serve.prepare"]
    assert len(prepare) == 2
    assert all(s.thread != main and s.parent == -1 for s in prepare)
    mine = [s for s in rec.spans if s.thread == main]
    top = [s.name for s in mine if s.parent == -1]
    assert top == ["serve.queue_wait", "serve.batch", "serve.results"] * 2 + ["serve.queue_wait"]
    for batch in [s for s in mine if s.name == "serve.batch"]:
        inside = [s for s in mine if s is not batch
                  and batch.start_ns <= s.start_ns <= s.end_ns <= batch.end_ns]
        names = [s.name for s in inside]
        assert set(names) <= set(SERVE_BATCH) and names[:3] == [
            "serve.upload", "serve.encode", "serve.upload"]
        assert names.count("decode.prefill") == 1 and names[-1] == "serve.readback"
        steps, syncs = names.count("decode.step"), names.count("decode.sync")
        assert 0 <= steps <= 3 and syncs in (steps, steps + 1)
        # each step follows the read that let it run
        assert all(names[i - 1] == "decode.sync" for i, n in enumerate(names)
                   if n == "decode.step")
        # the upload inside the encoders is the video's
        encode = inside[names.index("serve.encode")]
        assert inside[2].parent == rec.spans.index(encode)
    rows = 2 * 3  # every batch holds batch_size rows
    assert rec.counters["h2d_bytes"] == rows * (16000 * 4 + 25 * 88 * 88 * 4)


# -- training --------------------------------------------------------------


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _train_spans(rec, n_steps):
    """Each training step's spans on this thread: data.batch, then
    train.step with its upload, forward, backward and optimizer."""
    main = threading.get_ident()
    mine = [s for s in rec.spans if s.thread == main]
    assert [s.name for s in mine if s.parent == -1] == ["data.batch", "train.step"] * n_steps
    steps = [s for s in mine if s.name == "train.step"]
    for step in steps:
        inner = [s.name for s in mine if s.parent == rec.spans.index(step)]
        assert inner == ["train.upload", "train.forward", "train.backward", "train.optimizer"]
        assert all(s.parent == rec.spans.index(step) for s in mine if s is not step
                   and step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns)


def test_torch_avhubert_step_records_training_spans_and_changes_nothing():
    from avsl_tpu_torch.cli.avhubert_ft import collate_av, make_optimizer, \
        make_synthetic_av_batchset
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.models import build_avhubert
    from avsl_tpu_torch.train import TrainState, make_train_step
    from avsl_tpu_torch.train.objectives import avhubert_seq2seq_loss_fn

    cfg = AVHuBERTConfig.tiny_test(dtype="float32", modality_dropout=0.2, audio_dropout=0.5)
    rows = make_synthetic_av_batchset(4, t=12, image=24, vocab=cfg.vocab_size, seed=2)

    def run(record):
        model = build_avhubert(cfg, "seq2seq", device="cpu", seed=0)
        step = make_train_step(avhubert_seq2seq_loss_fn(model, train=True))
        state = TrainState.create(model, make_optimizer(model, 1e-3, 10), seed=0)
        nbytes = 0
        with spans.recording() if record else _nothing() as rec:
            for i in range(2):
                batch = collate_av(rows[2 * i: 2 * i + 2], cfg.pad_token_id)
                nbytes += sum(v.nbytes for v in batch.values())
                state, _ = step(state, batch)
        return _params(model), rec, nbytes

    want, _, _ = run(False)
    got, rec, nbytes = run(True)
    assert want.keys() == got.keys()
    assert all(torch.equal(want[k], got[k]) for k in want)
    _train_spans(rec, 2)
    assert rec.counters["h2d_bytes"] == nbytes


def test_torch_flamingo_micro_steps_record_training_spans_and_change_nothing(tmp_path):
    from avsl_tpu_torch.cli.finetune import make_job, train_batches
    from avsl_tpu_torch.core.config import FlamingoTrainConfig

    cfg = FlamingoTrainConfig(
        model_name="test", audio_max_length=16000, batch_size=2, gradient_accumulation_steps=2,
        num_train_steps=10, warmup_steps=1, precision="32", dropout_rate=0.1,
        spec_augment="ls-basic", enable_gradient_checkpointing=False,
        log_output_dir=str(tmp_path / "logs"), check_output_dir=str(tmp_path / "ckpt"))
    rng = np.random.default_rng(4)
    rows = [{"audio": {"array": (0.2 * rng.standard_normal(16000)).astype(np.float32),
                       "sampling_rate": 16000},
             "transcript": "one two three"[: 3 + 4 * (i % 3)], "duration": 1.0,
             "lip_video": None} for i in range(8)]

    def run(record):
        job = make_job(cfg, rows, None, None, "cpu", seed=0)
        runner = job.runner
        assert runner.accum == 1  # MultiSteps accumulates across the batches
        it = train_batches(job, 0)
        nbytes = 0
        with spans.recording() if record else _nothing() as rec:
            for _ in range(2):
                batch = next(it)
                nbytes += sum(np.asarray(v).nbytes for v in batch.values())
                runner.state, _ = runner.train_step(runner.state, runner.reshape_accum(batch))
        assert runner.state.optimizer.mini_step == 0  # the second micro-step updated
        return _params(job.model), rec, nbytes

    want, _, _ = run(False)
    got, rec, nbytes = run(True)
    assert all(torch.equal(want[k], got[k]) for k in want)
    _train_spans(rec, 2)
    assert rec.counters["h2d_bytes"] == nbytes


def test_torch_prefetch_counts_uploads_and_records_its_waits():
    """The prefetcher counts the bytes of every batch it moves as
    ``h2d_bytes`` and records the consumer's wait on its queue as
    ``data.wait`` on the consumer's thread; the batches arrive as they
    do unrecorded."""
    from avsl_tpu_torch.data.prefetch import prefetch_to_device

    rng = np.random.default_rng(3)
    batches = [{"x": rng.standard_normal((2, 5)).astype(np.float32),
                "y": np.arange(3, dtype=np.int64) + i} for i in range(3)]
    want = list(prefetch_to_device(iter(batches), "cpu"))
    with spans.recording() as rec:
        got = list(prefetch_to_device(iter(batches), "cpu"))
    assert all(torch.equal(w[k], g[k]) for w, g in zip(want, got) for k in w)
    assert rec.counters == {"h2d_bytes": sum(v.nbytes for b in batches for v in b.values())}
    main = threading.get_ident()
    # one wait a batch and one for the end of the stream
    assert [(s.name, s.thread) for s in rec.spans] == [("data.wait", main)] * 4


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


# -- on the card -------------------------------------------------------------


@pytest.mark.card
def test_torch_spans_share_the_device_trace_clock():
    """A span around a ~20 ms device sleep and its synchronize starts and
    ends within 0.5 ms of the sleep's interval as the profiler stamps it."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the device trace's clock is read on the chip")
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with spans.recording() as rec:
            with spans.span("sleep"):
                torch.cuda._sleep(40_000_000)
                torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    k = max(kernels, key=lambda e: e.duration_ns())
    (s,) = rec.spans
    lead, lag = k.start_ns() - s.start_ns, s.end_ns - (k.start_ns() + k.duration_ns())
    print(f"sleep kernel {k.duration_ns() / 1e6:.3f} ms; span start to kernel start "
          f"{lead / 1e3:.1f} us, kernel end to span end {lag / 1e3:.1f} us")
    assert k.duration_ns() > 5 * MS
    assert abs(lead) <= 0.5 * MS and abs(lag) <= 0.5 * MS
