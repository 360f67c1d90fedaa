"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -shared -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so

into ``build/`` at the repository root, named after a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. nvcc's report (ptxas registers and spills) is kept beside
the library as ``<name>-<hash>.log``. The library is loaded with
``ctypes``; the wrapper passes every pointer and the stream as
``c_void_p``. Nothing is compiled or loaded at import time: the CPU has no
``nvcc`` and never calls :func:`load`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load", "BUILD_DIR", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(put the CUDA toolkit's bin/ on PATH)")


def _target(name: str) -> tuple[Path, Path]:
    """The source of ``name`` and its library, named after a hash of the
    source and the flags."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _build(name: str, src: Path, so: Path) -> None:
    """Compile ``src`` to a per-process temporary name, then rename it to
    ``so`` (atomic: a concurrent loader sees the whole library or none)."""
    cmd = [_nvcc(), *NVCC_FLAGS]
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([*cmd, "-o", str(tmp), str(src)], text=True,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    so.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, so)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            src, so = _target(name)
            if not so.exists():
                _build(name, src, so)
            lib = ctypes.CDLL(str(so))
            _LOADED[name] = lib
        return lib
