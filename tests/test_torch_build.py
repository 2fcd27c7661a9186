"""The kernels' build key: ``_build.source_digest`` names the built library,
so it must change whenever anything nvcc reads changes -- the source, a
header it includes, the flags -- or a stale library would be loaded."""

import re

import pytest

from horovod_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path):
    src = tmp_path / "kernel.cu"
    src.write_text('#include "prims.cuh"\n__global__ void k() {}\n')
    (tmp_path / "prims.cuh").write_text("// version 1\n")
    return src


@pytest.mark.parametrize("edit", ["header", "add_header", "source", "flags"])
def test_digest_changes_with_what_nvcc_reads(csrc, edit):
    before = _build.source_digest(csrc)
    assert _build.source_digest(csrc) == before  # stable when nothing changed
    flags = _build.NVCC_FLAGS
    if edit == "header":
        (csrc.parent / "prims.cuh").write_text("// version 2\n")
    elif edit == "add_header":
        (csrc.parent / "more.cuh").write_text("")
    elif edit == "source":
        csrc.write_text(csrc.read_text() + "// edited\n")
    else:
        flags = flags + ["-lineinfo"]
    assert _build.source_digest(csrc, flags) != before


def test_digest_ignores_files_that_are_not_headers(csrc):
    before = _build.source_digest(csrc)
    (csrc.parent / "notes.txt").write_text("not read by nvcc\n")
    (csrc.parent / "other.cu").write_text("// another library's source\n")
    assert _build.source_digest(csrc) == before


def test_every_quoted_include_is_a_hashed_header():
    """The rule the digest relies on: the port's sources include, by quotes,
    only ``*.cuh`` files that lie in ``csrc/`` itself."""
    files = sorted(_build.CSRC_DIR.glob("*.cu")) + \
        sorted(_build.CSRC_DIR.glob("*.cuh"))
    assert any(f.suffix == ".cuh" for f in files)
    for f in files:
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read_text(),
                               re.M):
            assert name.endswith(".cuh") and "/" not in name, (f.name, name)
            assert (_build.CSRC_DIR / name).exists(), (f.name, name)
