"""The kernels' build (``repro_torch.kernels._build``) without a CUDA toolkit:
a stand-in ``nvcc`` script takes the compiler's place, so what is checked is
the orchestration (every source compiled, libraries keyed by the source's
hash, the ptxas report kept, failures raised), not CUDA itself."""

import os
import stat

import pytest

from repro_torch.kernels import _build


def _fake_nvcc(bin_dir, body):
    bin_dir.mkdir()
    path = bin_dir / "nvcc"
    path.write_text(
        "#!/bin/sh\n"
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        + body
    )
    path.chmod(path.stat().st_mode | stat.S_IEXEC)


@pytest.fixture
def throwaway(tmp_path, monkeypatch):
    """Sources, build directory and PATH of a throwaway build."""
    sources = {}
    for name in ("k_a", "k_b"):
        sources[name] = tmp_path / f"{name}.cu"
        sources[name].write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "SOURCES", sources)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    return tmp_path


def test_build_compiles_every_source_and_keeps_the_ptxas_report(throwaway):
    _fake_nvcc(throwaway / "bin", 'echo "ptxas info    : Used 8 registers"\n'
                                'echo "    0 bytes spill stores"\n'
                                'echo lib > "$out"\n')
    _build.build()
    for name in ("k_a", "k_b"):
        assert _build.library_path(name).read_text() == "lib\n"
        assert _build.ptxas_report(name) == [
            "ptxas info    : Used 8 registers", "0 bytes spill stores"]
    assert not [p for p in (throwaway / "build").iterdir() if ".tmp" in p.name]


def test_library_is_rebuilt_when_its_source_changes(throwaway):
    first = _build.library_path("k_a")
    _build.SOURCES["k_a"].write_text("// edited\n")
    assert _build.library_path("k_a") != first
    assert _build.library_path("k_b").parent == first.parent


def test_a_failed_compile_raises_with_the_compiler_output(throwaway):
    _fake_nvcc(throwaway / "bin", 'echo "error: no such intrinsic"\nexit 2\n')
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build(["k_a"])
    assert not _build.library_path("k_a").exists()


def test_no_nvcc_is_an_error(throwaway):
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("k_a")
    assert not os.listdir(throwaway / "build")


def test_library_is_rebuilt_when_a_header_it_includes_changes(throwaway):
    """A header outside the source's directory, and one it includes in
    turn, are part of the key; a source that does not include them is not
    rebuilt."""
    inc = throwaway / "shared"
    inc.mkdir()
    (inc / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (inc / "inner.cuh").write_text("// inner\n")
    _build.SOURCES["k_a"].write_text('#include "shared/outer.cuh"\n// k_a\n')
    assert _build.included_headers(_build.SOURCES["k_a"]) == [
        (inc / "inner.cuh").resolve(), (inc / "outer.cuh").resolve()]
    first_a, first_b = _build.library_path("k_a"), _build.library_path("k_b")
    (inc / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n// edited\n')
    second_a = _build.library_path("k_a")
    assert second_a != first_a
    (inc / "inner.cuh").write_text("// inner, edited\n")
    assert _build.library_path("k_a") not in (first_a, second_a)
    assert _build.library_path("k_b") == first_b


def test_the_paged_sources_are_keyed_by_the_headers_they_share():
    """K4 includes K2's fragment helpers from another directory: both they
    and the paged helpers beside it enter its key."""
    names = {h.name for h in _build.included_headers(_build.SOURCES["paged_prefill"])}
    assert names == {"flash_common.cuh", "paged_common.cuh"}
    names = {h.name for h in _build.included_headers(_build.SOURCES["paged_decode"])}
    assert names == {"paged_common.cuh"}


def test_the_flash_sources_are_keyed_by_the_hopper_header():
    """K2's forward and backward build on the wgmma/TMA helpers of
    ``flash_sm90.cuh``; K4 keeps the mma.sync helpers of ``flash_common.cuh``,
    so an edit to either rebuilds only the kernels that use it."""
    for name in ("flash_fwd", "flash_bwd"):
        names = {h.name for h in _build.included_headers(_build.SOURCES[name])}
        assert names == {"flash_sm90.cuh"}


def test_the_wkv6_sources_are_keyed_by_their_header_and_the_mma_helpers():
    """K5's forward and backward share the chunk-form helpers of
    ``wkv6_common.cuh``, which include K4's mma.sync helpers from
    ``flash_common.cuh``: an edit to either rebuilds both."""
    for name in ("wkv6_fwd", "wkv6_bwd"):
        names = {h.name for h in _build.included_headers(_build.SOURCES[name])}
        assert names == {"wkv6_common.cuh", "flash_common.cuh"}
