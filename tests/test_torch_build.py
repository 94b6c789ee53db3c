"""The kernel build's cache key, on the CPU (no ``nvcc`` needed).

A library is named by a hash of what it is built from, so an edit to the
source, to a header under ``csrc/`` or to the flags must give a new name
(and a rebuild), and nothing else may.
"""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "common.cuh"\n__global__ void k() {}\n')
    (src / "common.cuh").write_text("#pragma once\nconstexpr int kStages = 6;\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    return src


def test_lib_path_is_stable(csrc):
    first = _build._lib_path("k")
    assert first == _build._lib_path("k")
    assert first.parent == _build.BUILD and first.name.startswith("libk-")
    (csrc / "notes.txt").write_text("not a header")
    assert _build._lib_path("k") == first


def _edit_header(csrc, monkeypatch):
    (csrc / "common.cuh").write_text("#pragma once\nconstexpr int kStages = 4;\n")


def _add_header(csrc, monkeypatch):
    (csrc / "other.cuh").write_text("#pragma once\n")


def _edit_source(csrc, monkeypatch):
    (csrc / "k.cu").write_text('#include "common.cuh"\n__global__ void k2() {}\n')


def _change_flags(csrc, monkeypatch):
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-lineinfo"))


@pytest.mark.parametrize(
    "change", [_edit_header, _add_header, _edit_source, _change_flags],
    ids=["edited_header", "new_header", "edited_source", "flags"],
)
def test_lib_path_changes_with_what_the_library_is_built_from(
    csrc, monkeypatch, change
):
    before = _build._lib_path("k")
    change(csrc, monkeypatch)
    assert _build._lib_path("k") != before
