"""The kernel build's cache key covers every header a source includes.

A library's file name carries a hash of its ``.cu`` source and of every
local header that source ``#include``s, recursively, so an edited header
rebuilds each library that includes it and no other.  Everything here
works on a copy of ``csrc/`` under ``tmp_path``; nothing is compiled.
"""

import re
import shutil

import pytest

from fusioninfer_tpu_torch.ops import _build

SOURCES = sorted(_build.SIGNATURES)
CSRC_FILES = sorted(p.name for p in _build.CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


@pytest.fixture
def csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    return dst


def _touch(path):
    path.write_text(path.read_text() + "\n// edited\n")


@pytest.mark.parametrize("source", SOURCES)
def test_header_edit_rebuilds_exactly_its_includers(csrc, source):
    """Editing a header changes the library path of a source that
    includes it and leaves that of a source that does not."""
    src = csrc / source
    included = {p.name for p in _build.local_includes(src)[1:]}
    for header in sorted(csrc.glob("*.cuh")):
        before = _build._lib_path(src)
        _touch(header)
        assert (_build._lib_path(src) != before) == (header.name in included), header.name


@pytest.mark.parametrize("source", SOURCES)
def test_source_edit_changes_its_library_path(csrc, source):
    src = csrc / source
    before = _build._lib_path(src)
    _touch(src)
    after = _build._lib_path(src)
    assert after != before
    assert after.name.startswith(f"lib{src.stem}-") and after.parent == _build.BUILD_DIR


def test_window_and_flash_kernels_share_the_hopper_header():
    for source in ("flash_attention.cu", "paged_window_attention.cu"):
        names = [p.name for p in _build.local_includes(_build.CSRC / source)]
        assert names == [source, "hopper_attention.cuh"]


def test_page_walks_include_the_hopper_header():
    """The single walk and paged decode take their mbarriers, bulk copies
    and cluster wrappers from the shared header, so editing it rebuilds
    the page walks too."""
    names = [p.name for p in _build.local_includes(_build.CSRC / "paged_attention.cu")]
    assert names == ["paged_attention.cu", "hopper_attention.cuh"]


def test_nested_includes_are_hashed(tmp_path):
    """A header included by a header counts as well, each file once."""
    (tmp_path / "inner.cuh").write_text("#pragma once\nconstexpr int X = 1;\n")
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    src = tmp_path / "k.cu"
    src.write_text('#include "outer.cuh"\n#include "inner.cuh"\n')
    assert [p.name for p in _build.local_includes(src)] == ["k.cu", "outer.cuh", "inner.cuh"]
    before = _build._lib_path(src)
    _touch(tmp_path / "inner.cuh")
    assert _build._lib_path(src) != before


def test_unresolved_include_raises(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text('#include "missing.cuh"\n')
    with pytest.raises(FileNotFoundError, match="missing.cuh"):
        _build._lib_path(src)


@pytest.mark.parametrize("name", CSRC_FILES)
def test_every_local_include_in_csrc_resolves(name):
    path = _build.CSRC / name
    for inc in re.findall(r'^\s*#\s*include\s*"([^"]+)"', path.read_text(), re.MULTILINE):
        assert (path.parent / inc).is_file(), f"{name} includes {inc!r}"
    assert _build.local_includes(path)[0] == path.resolve()
