"""Build the port's CUDA sources into shared libraries, load and launch them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -shared -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so

into ``build/`` at the repository root, named after a hash of the source,
every ``csrc/`` header it includes (``#include "x.cuh"``, followed
through the headers' own includes) and the flags, so an edited source or
header is rebuilt and an unchanged one is loaded as it is. nvcc's report
(ptxas registers and spills) is kept beside the library as
``<name>-<hash>.log``; :func:`ptxas_entries` reads it. :func:`build`
starts one nvcc per missing source, all together, and waits for them.
The library is loaded with ``ctypes``; :func:`launch` passes every
pointer and the stream as ``c_void_p``. Nothing is compiled or loaded at
import time: the CPU has no ``nvcc`` and never calls :func:`load`.

A launch costs little more than the ctypes call itself: each ``(source,
entry)`` is resolved once into a typed ctypes function (argtypes set), the
lock is taken only while a source is first built and loaded, the device
context is entered only when the tensor's device is not the current one,
and the current stream's raw handle is read on every call without building
a ``torch.cuda.Stream``. Read per call, the handle is the capture stream
while a CUDA graph is being captured, so the launch lands in the graph.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["load", "build", "launch", "ptxas_entries", "SOURCES",
           "BUILD_DIR", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("gossip_mix", "flash_attention", "flash_attention_bwd",
           "rglru_scan", "rglru_scan_bwd", "rwkv6_scan", "rwkv6_scan_bwd",
           "quantize", "trace_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_LOADED: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_LOCK = threading.RLock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(put the CUDA toolkit's bin/ on PATH)")


def _includes(src: Path) -> list[Path]:
    """The files that ``src`` includes with quotes and that exist beside
    the file naming them, through their own includes, each once, in the
    order they are first met (as the compiler reads them; a quoted name
    found nowhere there is a system header, left to the toolkit)."""
    found: list[Path] = []
    todo = [src]
    while todo:
        path = todo.pop(0)
        for name in _INCLUDE.findall(path.read_text()):
            inc = (path.parent / name).resolve()
            if inc.is_file() and inc not in found and inc != src.resolve():
                found.append(inc)
                todo.append(inc)
    return found


def _target(name: str) -> tuple[Path, Path]:
    """The source of ``name`` and its library, named after a hash of the
    source, the headers it includes and the flags."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for inc in _includes(src):
        digest.update(inc.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def ptxas_entries(log: str) -> list[tuple[str, int, int, int]]:
    """(entry function, registers, spill store bytes, spill load bytes) of
    each kernel in an ``nvcc -Xptxas -v`` report (the ``.log`` beside a
    library)."""
    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spill))
            name = None
    return rows


def build(names=SOURCES) -> list[str]:
    """Compile every source of ``names`` whose library is missing: one nvcc
    each, all started together, each into a per-process temporary name that
    is renamed to the library when it is whole (a concurrent loader sees
    the whole library or none). Returns the names it built; raises with
    nvcc's output if any build failed."""
    with _LOCK:
        todo = [(n, *_target(n)) for n in names if not _target(n)[1].exists()]
        if not todo:
            return []
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        running = []
        for name, src, so in todo:
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)], text=True,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            running.append((name, so, tmp, proc))
        failed = []
        for name, so, tmp, proc in running:
            log, _ = proc.communicate()
            so.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed to build {name}.cu "
                              f"(exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
        return [name for name, *_ in todo]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)[1]))
            _LOADED[name] = lib
        return lib


def _entry(name: str, entry: str, argtypes: tuple):
    """C entry ``entry`` of ``csrc/<name>.cu`` as a typed ctypes function:
    every argument as given plus the stream (``c_void_p``), an ``int``
    CUDA error back. Without argtypes ctypes would pass each pointer as a
    32-bit int."""
    fn = getattr(load(name), entry)
    fn.argtypes = (*argtypes, ctypes.c_void_p)
    fn.restype = ctypes.c_int
    _ENTRIES[(name, entry)] = fn
    return fn


def launch(name: str, entry: str, argtypes: tuple, device: torch.device,
           *args) -> None:
    """Call C entry ``entry`` of ``csrc/<name>.cu`` with ``args`` and the
    current stream of ``device``; raises if it returns a CUDA error."""
    fn = _ENTRIES.get((name, entry)) or _entry(name, entry, argtypes)
    current = torch._C._cuda_getDevice()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
