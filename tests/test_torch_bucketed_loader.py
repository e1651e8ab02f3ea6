"""The port's dataset path against the JAX package (CPU): ``load_datasets``,
``AmiVideoDataset.audio_length`` and ``make_bucketed_loader``.

A tree of train/val/test splits is written by the JAX package's writer
(``tests/torch_dataset_fixtures.py``), a quarter of the train rows at 44.1
or 48 kHz, so the resampler runs inside the dataset; one more split is a
plain ``datasets.Dataset.from_list(...).save_to_disk`` of array rows.

* ``load_datasets``: the same split sizes and rows (ids, transcripts,
  durations) from explicit paths, from the siblings of a missing train
  path, with ``dataset_fraction`` 0.5 and with the duration filter;
* ``audio_length``: equal on a list of rows (with and without a
  duration), on a dataset on disk and on one without a duration column;
* ``make_bucketed_loader``: batch by batch, ``dec_input_ids``, ``labels``,
  ``audio_frames``, the video (one zero frame an item, no lip clips) and
  its mask and ``video_pad_len`` exact; the log-mel within atol 5e-5, rtol
  1e-5 (the port's log-mel parity, ``tests/test_torch_logmel.py``);
* one collator shared by a prefetched train loader and a validation loader
  on another thread: each loader's batches as it gives them alone.
"""

import threading

import datasets
import numpy as np
import pytest

from avsl_tpu.cli.finetune import load_datasets as jax_load_datasets
from avsl_tpu.core.config import FlamingoTrainConfig as JaxTrainConfig
from avsl_tpu.data.runtime import AmiVideoDataset as JaxDataset
from avsl_tpu.data.runtime import WhisperVideoCollator as JaxCollator
from avsl_tpu.data.runtime import make_bucketed_loader as jax_loader
from avsl_tpu.data.tokenizer import get_tokenizer as jax_get_tokenizer
from avsl_tpu_torch.cli.finetune import load_datasets
from avsl_tpu_torch.core.config import FlamingoTrainConfig
from avsl_tpu_torch.data.prefetch import prefetch_to_device
from avsl_tpu_torch.data.runtime import AmiVideoDataset, WhisperVideoCollator, make_bucketed_loader
from avsl_tpu_torch.data.tokenizer import get_tokenizer
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)
from torch_dataset_fixtures import write_tree

N_TRAIN = 16
DURATIONS = 0.3 + 1.6 * np.random.default_rng(3).random(N_TRAIN)  # 0.3-1.9 s
RATES = [(44100, 48000)[i % 2] if i % 4 == 1 else 16000 for i in range(N_TRAIN)]
AUDIO_MAX = 32000  # 2 s: lengths of 30-190 frames over the buckets 100, 142, 190


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ami")
    write_tree(root, {"train": N_TRAIN, "val": 5, "test": 4}, seed=1,
               durations={"train": DURATIONS}, rates={"train": RATES})
    rng = np.random.default_rng(9)
    rows = [{"id": f"a{i}", "transcript": f"array row {i}", "duration": d,
             "audio": {"array": (0.1 * rng.standard_normal(int(48000 * d))).astype(np.float32),
                       "sampling_rate": 48000}}
            for i, d in enumerate((0.4, 1.2, 0.7, 1.8, 0.5, 1.1))]
    datasets.Dataset.from_list(rows).save_to_disk(str(root / "plain"))
    return root


def _cfgs(**keys):
    return FlamingoTrainConfig(**keys), JaxTrainConfig(**keys)


def _rows(ds):
    return None if ds is None else [(r["id"], r["transcript"], r["duration"]) for r in ds]


@pytest.mark.parametrize("case", ["explicit", "siblings", "fraction", "filter"])
def test_torch_load_datasets_matches_jax(tree, case):
    paths = {f"{s}_data_path": str(tree / s) for s in ("train", "val", "test")}
    keys = {"explicit": dict(paths, max_duration_filter_seconds=0.0),
            # the train path is missing: its siblings are found
            "siblings": dict(train_data_path=str(tree / "train_missing"),
                             val_data_path="", test_data_path="",
                             max_duration_filter_seconds=0.0),
            "fraction": dict(paths, dataset_fraction=0.5, max_duration_filter_seconds=0.0),
            "filter": dict(paths, max_duration_filter_seconds=1.0)}[case]
    port_cfg, jax_cfg = _cfgs(**keys)
    got, want = load_datasets(port_cfg), jax_load_datasets(jax_cfg)
    assert [_rows(d) for d in got] == [_rows(d) for d in want]
    sizes = [len(d) for d in got]
    expect = {"explicit": [16, 5, 4], "siblings": [16, 5, 4], "fraction": [8, 2, 2]}
    if case == "filter":
        assert sizes[0] == int((DURATIONS <= 1.0).sum()) < N_TRAIN
    else:
        assert sizes == expect[case]


def _datasets(rows, train=True):
    port_tok, jax_tok = get_tokenizer(None, "en"), jax_get_tokenizer(None, "en")
    port_tok.add_tokens(["<laugh>"])
    jax_tok.add_tokens(["<laugh>"])
    port = AmiVideoDataset(rows, port_tok, audio_max_length=AUDIO_MAX, train=train)
    ref = JaxDataset(rows, jax_tok, audio_max_length=AUDIO_MAX, train=train)
    return (port, WhisperVideoCollator(port_tok.eot, label_pad_len=24, max_label_len=24),
            ref, JaxCollator(jax_tok.eot, label_pad_len=24, max_label_len=24))


def test_torch_audio_length_matches_jax(tree):
    on_disk = datasets.load_from_disk(str(tree / "train"))
    rows = [{"duration": 0.75}, {"duration": None}, {}, {"duration": "1.5"}]
    no_column = datasets.Dataset.from_list([{"transcript": "a"}, {"transcript": "b"}])
    for source in (on_disk, no_column, rows):
        port, _, ref, _ = _datasets(source)
        got = [port.audio_length(i) for i in range(len(source))]
        assert got == [ref.audio_length(i) for i in range(len(source))]
    assert got == [12000, AUDIO_MAX, AUDIO_MAX, 24000]


@pytest.mark.parametrize("split,shuffle,epoch,shards", [
    ("train", True, 0, 1), ("train", True, 1, 2), ("train", False, 0, 1), ("plain", True, 0, 1)])
def test_torch_bucketed_loader_matches_jax(tree, split, shuffle, epoch, shards):
    rows = datasets.load_from_disk(str(tree / split))
    port, port_col, ref, ref_col = _datasets(rows)
    bins = (AUDIO_MAX // 160) * 2
    got = list(make_bucketed_loader(port, port_col, bins, num_shards=shards, shuffle=shuffle,
                                    epoch=epoch))
    want = list(jax_loader(ref, ref_col, bins, num_shards=shards, shuffle=shuffle, epoch=epoch))
    assert len(got) == len(want) > 2
    assert len({b["video"].shape[:2] for b in got}) > 1  # the batches vary in shape
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in ("dec_input_ids", "labels", "audio_frames", "video", "video_mask"):
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        np.testing.assert_allclose(g["input_ids"], w["input_ids"], atol=5e-5, rtol=1e-5)
        assert g["video"].shape[0] % shards == 0
    # JAX leaves the last batch's pad length on its collator; the port
    # hands it to each call and leaves the shared collator as it was
    assert got[-1]["video"].shape[1] == ref_col.video_pad_len
    assert port_col.video_pad_len is None


def test_torch_bucketed_loader_shares_its_collator_across_threads(tree):
    """A prefetched train loader and a validation loader on the main thread
    share one collator (as ``cli.finetune.make_job`` gives both theirs).
    The producer is held inside its first collation while the main thread
    collates every validation batch; each loader's batches must come out
    as they do alone."""
    train, col, _, _ = _datasets(datasets.load_from_disk(str(tree / "train")))
    val = _datasets(datasets.load_from_disk(str(tree / "val")), train=False)[0]
    bins = (AUDIO_MAX // 160) * 2

    def shapes(batches):
        return [(b["video"].shape, np.asarray(b["video_mask"]).sum()) for b in batches]

    want_train = shapes(make_bucketed_loader(train, col, bins, epoch=0))
    want_val = shapes(make_bucketed_loader(val, col, bins, shuffle=False))
    # a validation that leaked its pad length would show in the first batch
    assert want_val[-1][0][1] != want_train[0][0][1]
    entered, turn = threading.Event(), threading.Event()

    class HeldCollator(WhisperVideoCollator):
        def __call__(self, items, **kw):
            if threading.current_thread() is not threading.main_thread() and not turn.is_set():
                entered.set()
                turn.wait(timeout=30)
            return super().__call__(items, **kw)

    held = HeldCollator(col.eot_id, label_pad_len=24, max_label_len=24)
    got_train = []
    consumer = threading.Thread(target=lambda: got_train.extend(prefetch_to_device(
        make_bucketed_loader(train, held, bins, epoch=0), "cpu", size=1)))
    consumer.start()
    assert entered.wait(timeout=30)  # the producer is inside its first collation
    got_val = shapes(make_bucketed_loader(val, held, bins, shuffle=False))
    turn.set()
    consumer.join(timeout=60)
    assert not consumer.is_alive()
    assert shapes(got_train) == want_train
    assert got_val == want_val
