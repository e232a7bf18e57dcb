"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exports plain C entry points (pointers and the
stream as `void*`, sizes as `int`, a `cudaError_t` returned as `int`), so
it compiles in seconds without PyTorch's headers. The library is built
at first use into `_build/` beside this package (listed in .gitignore),
named after a hash of its source and the shared `csrc/*.cuh` headers, so
an edited source never loads a stale build. Nothing is built when a
module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["BUILD_DIR", "build", "check", "load"]

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME): the "
                       "port's CUDA kernels are built from source at first use")


def _target(name: str) -> Path:
    # the shared headers are part of every source's hash
    text = b"".join(p.read_bytes() for p in
                    [SRC_DIR / f"{name}.cu", *sorted(SRC_DIR.glob("*.cuh"))])
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()
                          ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no current build, one nvcc
    process per source, all started together. -> {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: _target(n) for n in names}
    procs = []
    for name, so in out.items():
        if so.exists():
            continue
        # write to a private name, then rename: a concurrent build or
        # load never sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, so)
        else:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exit {proc.returncode}\n"
                          f"{log.decode(errors='replace')}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for `csrc/<name>.cu`, building it if needed."""
    lib = ctypes.CDLL(str(build([name])[name]))
    lib.w2v_cuda_error_string.argtypes = [ctypes.c_int]
    lib.w2v_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, what: str, err: int) -> None:
    """Raise if an entry point of `lib` returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.w2v_cuda_error_string(err).decode())
