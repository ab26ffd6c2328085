"""The kernel build's cache key, on the CPU (no nvcc needed).

`build.library_path` names a kernel's library by a hash of its `.cu`, of
every file of `csrc/` that it includes (followed recursively) and of the
flags, so that an edited header rebuilds the libraries that include it
and leaves the others alone.
"""
import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text(
        '#include <cuda_runtime.h>\n#include "a.cuh"\nint k() { return A; }\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n'
                                    "#define A B\n")
    (tmp_path / "b.cuh").write_text("#pragma once\n#define B 1\n")
    (tmp_path / "other.cuh").write_text("#pragma once\n")
    (tmp_path / "plain.cu").write_text("int plain() { return 0; }\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return tmp_path


@pytest.mark.parametrize("edited,rebuilds", [
    ("k.cu", {"k"}),
    ("a.cuh", {"k"}),              # included directly
    ("b.cuh", {"k"}),              # included by an include
    ("other.cuh", set()),          # included by nothing
    ("plain.cu", {"plain"}),
])
def test_library_path_follows_includes(csrc, edited, rebuilds):
    before = {n: build.library_path(n) for n in ("k", "plain")}
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    after = {n: build.library_path(n) for n in ("k", "plain")}
    assert {n for n in before if before[n] != after[n]} == rebuilds


def test_library_path_survives_an_include_cycle(csrc):
    (csrc / "b.cuh").write_text('#pragma once\n#include "a.cuh"\n')
    assert build.library_path("k").name.startswith("libk-")


def test_library_path_sees_the_flags(csrc, monkeypatch):
    before = build.library_path("k")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("k") != before


def test_the_real_kernels_include_the_hopper_header():
    """flash_attention.cu, int8_matmul.cu, moe_gemm.cu and ssm_scan.cu
    include csrc/hopper.cuh, so the header is part of their keys; a
    kernel that does not include it (paged_attention.cu) keeps its own."""
    for name in ("flash_attention", "int8_matmul", "moe_gemm", "ssm_scan"):
        srcs = build._sources((build.CSRC / f"{name}.cu").resolve(), {})
        assert [p.name for p in srcs] == [f"{name}.cu", "hopper.cuh"]
    paged = build._sources((build.CSRC / "paged_attention.cu").resolve(), {})
    assert [p.name for p in paged] == ["paged_attention.cu"]
