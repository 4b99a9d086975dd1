"""The kernel build of the port (ray_tpu_torch/_build.py): a library's
name hashes its own source and every shared header, so an edited header
rebuilds every kernel and a stale library is never loaded."""

import shutil

import pytest

from ray_tpu_torch import _build

HEADERS = sorted(p.name for p in _build._CSRC.glob("*.cuh"))


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, copy)
    monkeypatch.setattr(_build, "_CSRC", copy)
    return copy


def _paths():
    return {name: _build.library_path(name) for name in _build.KERNELS}


def _append(path, text):
    path.write_text(path.read_text() + text)


def test_headers_include_the_tile_machinery():
    assert "wgmma_tile.cuh" in HEADERS and "common.cuh" in HEADERS


@pytest.mark.parametrize("header", HEADERS)
def test_header_edit_changes_every_library(csrc, header):
    before = _paths()
    _append(csrc / header, "\n// edited\n")
    after = _paths()
    for name in ("flash_fwd", "flash_bwd"):
        assert after[name] != before[name], name
    assert all(after[n] != before[n] for n in _build.KERNELS)


def test_kernel_edit_changes_only_its_library(csrc):
    before = _paths()
    _append(csrc / "flash_fwd.cu", "\n// edited\n")
    after = _paths()
    assert after["flash_fwd"] != before["flash_fwd"]
    assert after["flash_bwd"] == before["flash_bwd"]
    assert after["paged_attention"] == before["paged_attention"]
