"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them by ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/kernels/lib<name>-<digest>.so`` at the root of the checkout
(a directory ``.gitignore`` lists).  The digest covers the source, every
header ``csrc/*.cuh`` (a source may include any of them) and the flags, so
an edited source or header rebuilds and an unchanged one is reused.  Nothing
is built at import: a wrapper calls :func:`load` at its first launch, and
:func:`build_all` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "SOURCES", "build_all", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("pairwise_distance", "flash_attention", "flash_attention_bwd",
           "wkv6", "lru_scan", "moe_rows")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each fresh build
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str):
    """Start compiling ``name`` unless its library exists; returns the
    running process (or None) and the final library path."""
    path = _lib_path(name)
    if path.exists():
        return None, path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, path


def _finish(name: str, proc, path: Path) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    build_logs[name] = out
    os.replace(tmp, path)   # atomic: a reader never sees a partial library


def build_all(names=SOURCES) -> float:
    """Compile every source in parallel (one ``nvcc`` each); returns the
    wall seconds the build took (0 when every library was already there)."""
    t0 = time.perf_counter()
    started = [(n, *_start(n)) for n in names]
    for name, proc, path in started:
        _finish(name, proc, path)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        proc, path = _start(name)
        _finish(name, proc, path)
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib
