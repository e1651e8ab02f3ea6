"""``cli.finetune`` of the port and of the JAX package on a dataset on
disk whose first train wav is at 44.1 kHz, so the resampler runs inside
both datasets (CPU); otherwise as ``tests/test_torch_dataset_cli.py``,
in a file of its own to keep each file's time short."""

from test_torch_dataset_cli import finetune_like_jax
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)


def test_torch_finetune_trains_on_a_resampled_dataset_like_jax(tmp_path, monkeypatch):
    finetune_like_jax(tmp_path, monkeypatch, 44100)
