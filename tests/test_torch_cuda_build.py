"""PyTorch port, the kernel build's cache key: a library is named by a hash
of its source, every header under ``csrc/`` and the nvcc flags, so that an
edited source or header never loads a stale library. Needs no ``nvcc``."""

import shutil

import pytest

from multi_modal_early_exit_tpu_torch.ops import cuda_build

HEADERS = sorted(p.name for p in cuda_build.CSRC.glob("*.cuh"))


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that the build reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, copy)
    monkeypatch.setattr(cuda_build, "CSRC", copy)
    return copy


def test_every_header_is_keyed():
    assert {"common.cuh", "sm90.cuh"} <= set(HEADERS)


def test_key_is_stable(csrc):
    before = {n: cuda_build.library_path(n) for n in cuda_build.SOURCES}
    assert {n: cuda_build.library_path(n) for n in cuda_build.SOURCES} == before
    assert len(set(before.values())) == len(before)


@pytest.mark.parametrize("header", HEADERS)
@pytest.mark.parametrize("name", cuda_build.SOURCES)
def test_editing_a_header_changes_every_library(csrc, header, name):
    before = cuda_build.library_path(name)
    with open(csrc / header, "a") as f:
        f.write("\n// edited\n")
    assert cuda_build.library_path(name) != before


@pytest.mark.parametrize("name", cuda_build.SOURCES)
def test_editing_a_source_changes_only_its_library(csrc, name):
    before = {n: cuda_build.library_path(n) for n in cuda_build.SOURCES}
    with open(csrc / f"{name}.cu", "a") as f:
        f.write("\n// edited\n")
    after = {n: cuda_build.library_path(n) for n in cuda_build.SOURCES}
    assert [n for n in cuda_build.SOURCES if after[n] != before[n]] == [name]


def test_a_new_header_changes_the_key(csrc):
    before = cuda_build.library_path("flash_attention_packed_train")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert cuda_build.library_path("flash_attention_packed_train") != before


def test_the_flags_change_the_key(csrc, monkeypatch):
    before = cuda_build.library_path("flash_attention_packed_train")
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ("-lineinfo",))
    assert cuda_build.library_path("flash_attention_packed_train") != before
