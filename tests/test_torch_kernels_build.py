"""The kernels' build key (``kernels/build.py``), on the CPU: no nvcc is
needed to name a library."""

import shutil

import pytest

from priordepth_gaussiansplatting_torch.kernels import build

COMPOSITORS = ("composite_fwd", "composite_bwd")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that the build module reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


def test_editing_a_shared_header_renames_the_libraries_that_include_it(csrc):
    before = {n: build.library_path(n) for n in COMPOSITORS
              + ("segment_reduce",)}
    header = csrc / "composite_eval.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in before}
    for name in COMPOSITORS:
        assert after[name] != before[name], name
        assert after[name].name.startswith(f"lib{name}-")
    assert after["segment_reduce"] == before["segment_reduce"]


def test_the_key_follows_the_source_and_the_flags(csrc, monkeypatch):
    path = build.library_path("composite_bwd")
    assert build.library_path("composite_bwd") == path
    src = csrc / "composite_bwd.cu"
    src.write_text(src.read_text() + "\n")
    edited = build.library_path("composite_bwd")
    assert edited != path
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("composite_bwd") != edited


def test_every_source_names_its_included_headers():
    assert build._sources(build.CSRC / "gather_rows.cu", []) == [
        build.CSRC / "gather_rows.cu"]
    for name in ("expand_pairs", "segment_reduce"):
        assert build._sources(build.CSRC / f"{name}.cu", []) == [
            build.CSRC / f"{name}.cu", build.CSRC / "warp_search.cuh"]
    for name in COMPOSITORS:
        assert build._sources(build.CSRC / f"{name}.cu", []) == [
            build.CSRC / f"{name}.cu", build.CSRC / "composite_eval.cuh"]
