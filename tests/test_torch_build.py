"""The port's kernel build (ops/build.py) names each library by a hash
of its source, of every ``csrc/`` header the source includes (directly
or through another header) and of the compiler flags, so that editing a
shared header never loads a stale build.  Nothing here runs nvcc."""

import os

import pytest

from parameter_server_distributed_tpu_torch.ops import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", str(tmp_path))

    def write(name, text):
        (tmp_path / name).write_text(text)

    write("a.cu", '#include <cuda_bf16.h>\n#include "shared.cuh"\n'
                  'extern "C" int f() { return 0; }\n')
    write("b.cu", 'extern "C" int g() { return 0; }\n')
    write("shared.cuh", '#pragma once\n#include "inner.cuh"\n')
    write("inner.cuh", "constexpr int X = 1;\n")
    write("unused.cuh", "constexpr int Y = 1;\n")
    return write


def test_inputs_follow_includes_through_headers(csrc):
    assert sorted(build.inputs("a")) == ["a.cu", "inner.cuh", "shared.cuh"]
    assert build.inputs("b") == ["b.cu"]


@pytest.mark.parametrize("header", ["shared.cuh", "inner.cuh"])
def test_editing_an_included_header_changes_the_library(csrc, header):
    before_a, before_b = build.library_path("a"), build.library_path("b")
    csrc(header, "constexpr int X = 2;\n")
    assert build.library_path("a") != before_a
    assert build.library_path("b") == before_b
    assert os.path.dirname(build.library_path("a")) == build.BUILD_DIR


def test_a_header_nothing_includes_changes_nothing(csrc):
    before = build.library_path("a")
    csrc("unused.cuh", "constexpr int Y = 2;\n")
    assert build.library_path("a") == before
    csrc("a.cu", '#include "shared.cuh"\n')
    assert build.library_path("a") != before


def test_every_port_source_hashes_its_headers():
    """The flash sources share csrc/flash_mma.cuh."""
    for name in ("flash_fwd", "flash_bwd"):
        assert "flash_mma.cuh" in build.inputs(name)
    assert build.inputs("fused_update") == ["fused_update.cu"]


def test_the_device_close_builds_without_contraction(monkeypatch):
    """csrc/device_apply.cu is held to the host numpy optimizers bit for
    bit: its build adds no-FMA, IEEE divide / sqrt and denormal flags,
    which its library name hashes; the other sources keep the common
    flags."""
    assert "device_apply" in build.SOURCES
    extra = build.flags("device_apply")[len(build.NVCC_FLAGS):]
    assert set(extra) == {"--fmad=false", "-prec-div=true",
                          "-prec-sqrt=true", "-ftz=false"}
    assert build.flags("fused_update") == build.NVCC_FLAGS
    before = build.library_path("device_apply")
    monkeypatch.setitem(build.EXTRA_FLAGS, "device_apply", ())
    assert build.library_path("device_apply") != before
