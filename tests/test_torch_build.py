"""The kernel build's cache key: a library's file name hashes its source,
every ``csrc/*.cuh`` header and the nvcc flags, so an edit to any of them
builds anew instead of loading a stale library.  Runs on a copy of
``csrc/``; needs no nvcc."""

import shutil

import pytest

from pnpflow_tpu_torch.ops import _build

NAMES = sorted(_build.SOURCES)


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    d = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, d)
    monkeypatch.setattr(_build, "_CSRC", d)
    return d


@pytest.mark.parametrize("name", NAMES)
def test_unchanged_inputs_keep_the_path(csrc, name):
    assert _build.library_path(name) == _build.library_path(name)
    assert _build.library_path(name).parent == _build.BUILD_DIR


@pytest.mark.parametrize("name", NAMES)
def test_adding_or_editing_a_header_changes_the_path(csrc, name):
    before = _build.library_path(name)
    (csrc / "common.cuh").write_text("// one\n")
    added = _build.library_path(name)
    (csrc / "common.cuh").write_text("// two\n")
    edited = _build.library_path(name)
    assert len({before, added, edited}) == 3


@pytest.mark.parametrize("name", NAMES)
def test_changing_the_flags_changes_the_path(csrc, monkeypatch, name):
    before = _build.library_path(name)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build.library_path(name) != before


@pytest.mark.parametrize("name", NAMES)
def test_editing_a_source_changes_only_its_own_path(csrc, name):
    paths = {k: _build.library_path(k) for k in NAMES}
    with open(csrc / f"{name}.cu", "a") as f:
        f.write("\n// edited\n")
    for k in NAMES:
        assert (_build.library_path(k) != paths[k]) == (k == name)
