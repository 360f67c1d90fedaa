"""The name of each CUDA library: ``kernels/_build.py`` hashes the source,
every ``csrc/`` header it includes (through the headers' own includes) and
the nvcc flags, so that an edited header rebuilds the libraries of the
sources that include it and only those. Runs on a copy of ``csrc/`` in a
temporary directory; needs no nvcc. Also the ptxas report reader the
build checks (chip_smoke.py phase 2, the card tests) go through.
"""
import shutil

import pytest

pytest.importorskip("torch")  # the reference's CI installs no torch

from repro_torch.kernels import _build

# the sources that include csrc/flash_hopper.cuh, and the others
HOPPER = ("flash_attention", "flash_attention_bwd")
OTHERS = tuple(n for n in _build.SOURCES if n not in HOPPER)


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that ``_build`` reads instead of the real one."""
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    monkeypatch.setattr(_build, "CSRC", dst)
    return dst


def _edit(path):
    path.write_text(path.read_text() + "\n// edited\n")


def _libraries():
    return {name: _build._target(name)[1] for name in _build.SOURCES}


def test_every_quoted_include_of_a_source_is_found():
    """The flash sources include flash_hopper.cuh and nothing else of
    csrc/; the other sources include nothing of it (their libraries keep
    the names a hash of source and flags alone gives)."""
    for name in _build.SOURCES:
        want = [_build.CSRC / "flash_hopper.cuh"] if name in HOPPER else []
        assert _build._includes(_build.CSRC / f"{name}.cu") == want


@pytest.mark.parametrize("name", HOPPER)
def test_editing_an_included_header_renames_the_library(csrc, name):
    before = _build._target(name)[1]
    _edit(csrc / "flash_hopper.cuh")
    after = _build._target(name)[1]
    assert after != before
    assert after.parent == _build.BUILD_DIR
    assert after.name.startswith(f"{name}-") and after.suffix == ".so"


@pytest.mark.parametrize("name", OTHERS)
def test_editing_a_header_keeps_the_libraries_that_do_not_include_it(csrc,
                                                                     name):
    before = _build._target(name)[1]
    _edit(csrc / "flash_hopper.cuh")
    assert _build._target(name)[1] == before


@pytest.mark.parametrize("name", _build.SOURCES)
def test_editing_an_unrelated_file_keeps_the_library(csrc, name):
    """Another source edited, a header nobody includes added: the
    library's name stays."""
    before = _build._target(name)[1]
    other = next(n for n in _build.SOURCES if n != name)
    _edit(csrc / f"{other}.cu")
    (csrc / "unused.cuh").write_text("// included by no source\n")
    assert _build._target(name)[1] == before


@pytest.mark.parametrize("name", _build.SOURCES)
def test_editing_the_source_renames_only_its_library(csrc, name):
    before = _libraries()
    _edit(csrc / f"{name}.cu")
    after = _libraries()
    assert [n for n in _build.SOURCES if after[n] != before[n]] == [name]


def test_a_header_included_by_a_header_is_followed(csrc):
    """flash_hopper.cuh including a second header: editing that one
    renames both flash libraries, and a header that includes itself or
    a missing (system) name ends the walk."""
    hopper = csrc / "flash_hopper.cuh"
    (csrc / "nested.cuh").write_text('#include "flash_hopper.cuh"\n'
                                     '#include "cuda_fp8.h"\n')
    hopper.write_text('#include "nested.cuh"\n' + hopper.read_text())
    assert _build._includes(csrc / "flash_attention_bwd.cu") == [
        hopper.resolve(), (csrc / "nested.cuh").resolve()]
    before = _libraries()
    _edit(csrc / "nested.cuh")
    after = _libraries()
    assert sorted(n for n in _build.SOURCES if after[n] != before[n]) == \
        sorted(HOPPER)


_DQ = "_ZN12_GLOBAL__N_124flash_bwd_dq_bf16_kernelILi128EEEv"
_KV = "_ZN12_GLOBAL__N_121flash_bwd_dkdv_kernelIfLi64EEEv"
_LOG = f"""\
ptxas info    : Compiling entry function '{_DQ}' for 'sm_90a'
ptxas info    : Function properties for {_DQ}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '{_KV}' for 'sm_90a'
ptxas info    : Function properties for {_KV}
    24 bytes stack frame, 16 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
"""


def test_ptxas_entries_reads_registers_and_spills_per_kernel():
    assert _build.ptxas_entries(_LOG) == [(_DQ, 168, 0, 0),
                                          (_KV, 255, 16, 8)]
    assert _build.ptxas_entries("") == []
