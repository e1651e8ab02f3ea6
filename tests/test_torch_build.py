"""The kernel build is named by everything it compiles (CPU, no nvcc).

``kernels/_build.py`` names each shared library by a hash of its ``.cu``
source, the ``csrc/*.cuh`` headers that source includes, and the nvcc
flags. An edited header must name a new library, or a stale one would be
loaded; a header the source does not include must not.
"""

import shutil

import pytest

from avsl_tpu_torch.kernels import _build

SOURCES = ("flash_attn_fwd", "flash_attn_bwd")


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", SOURCES)
def test_torch_build_sources_list_the_included_header(name):
    found = [p.name for p in _build._sources(_build.CSRC / f"{name}.cu")]
    assert found == [f"{name}.cu", "hopper_tiles.cuh"]


@pytest.mark.parametrize("name", SOURCES)
def test_torch_build_target_follows_an_edited_header(name, csrc_copy):
    before = _build._target(name)[1]
    header = csrc_copy / "hopper_tiles.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build._target(name)[1]
    assert after != before
    assert after.parent == before.parent and after.name.startswith(f"lib{name}-")


@pytest.mark.parametrize("name", SOURCES)
def test_torch_build_target_ignores_a_header_not_included(name, csrc_copy):
    before = _build._target(name)[1]
    (csrc_copy / "unused.cuh").write_text("// not included by any source\n")
    assert _build._target(name)[1] == before


def test_torch_build_target_follows_the_source_and_the_flags(csrc_copy, monkeypatch):
    before = _build._target("flash_attn_fwd")[1]
    src = csrc_copy / "flash_attn_fwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    edited = _build._target("flash_attn_fwd")[1]
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert len({before, edited, _build._target("flash_attn_fwd")[1]}) == 3
