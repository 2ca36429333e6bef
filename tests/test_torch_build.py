"""s2tpu_torch.ops._build keys a built library by its sources, the headers
of ``csrc/`` and the flags, so that an edited header rebuilds every library
that may include it. Runs on the CPU: it hashes files and calls no nvcc."""

import pytest

from s2tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "kernel.cu").write_text('#include "shared.cuh"\n__global__ void k() {}\n')
    (tmp_path / "other.cu").write_text("__global__ void o() {}\n")
    (tmp_path / "shared.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    return tmp_path


@pytest.mark.parametrize(
    "edit,rebuilds",
    [
        ("shared.cuh", True),  # a header: every library's key moves
        ("kernel.cu", True),  # one of the library's sources
        ("other.cu", False),  # a source of another library
        ("notes.txt", False),  # neither source nor header
    ],
)
def test_library_path_follows_sources_and_headers(csrc, edit, rebuilds):
    before = _build.library_path("kernel", ["kernel.cu"])
    with (csrc / edit).open("a") as f:
        f.write("// edited\n")
    after = _build.library_path("kernel", ["kernel.cu"])
    assert (after != before) == rebuilds
    assert after.parent == _build.BUILD_DIR and after.name.startswith("libkernel_")


def test_a_new_header_rebuilds(csrc):
    before = _build.library_path("kernel", ["kernel.cu"])
    (csrc / "more.h").write_text("#pragma once\n")
    assert _build.library_path("kernel", ["kernel.cu"]) != before
