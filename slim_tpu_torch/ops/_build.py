"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

Every source compiles with its own ``nvcc`` process, all started together,
into an object file; one link step makes ``libslim_kernels_<hash>.so`` in
``build/kernels/`` beside the package (listed in .gitignore).  The hash
covers the sources and the flags, so the library is rebuilt only when a
source changes.  The objects and the unlinked library carry the building
process's id, and the library takes its final name by ``os.replace``, so
processes that build at once (the ranks of a world, test workers) never
read another's half-written file.  The library has a plain C interface loaded with ctypes:
pointers and the CUDA stream travel as ``c_void_p``, and every entry
returns ``cudaGetLastError()``, which :func:`check` turns into an
exception.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C entry points and their argument types (see the csrc/ sources)
_SIGNATURES = {
    "slim_densify": [_P] * 4 + [_LL] + [_I] * 5 + [_P, _LL, _I, _I, _P],
    "slim_pack": [_P, _P, _I, _I, _I, _F, _P, _P, _P],
    "slim_cd_sweep": [_P] * 12 + [_I] * 3 + [_P] * 6,
    "slim_cd_sweep_large": [_P] * 12 + [_I] * 3 + [_P] * 6 + [_I, _P, _P],
    "slim_flush": [_P] * 7 + [_I] * 6 + [_P],
    "slim_flush_clusters": [],
    "slim_cd_sweep_panel": [_I] + [_P] * 12 + [_I] * 3 + [_P] * 7,
    "slim_gather": [_P, _LL, _P, _I, _P, _I, _I, _P, _P],
}

_lib = None


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(SRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources if the library for their hash is missing."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _digest()
    so = BUILD_DIR / f"libslim_kernels_{tag}.so"
    if so.exists():
        return so
    nvcc = nvcc_path()
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}_{tag}.{os.getpid()}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for src, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{out.decode(errors='replace')}")
    if errors:
        raise RuntimeError("nvcc failed\n" + "\n".join(errors))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, ARCH, "-shared", *map(str, objs), "-o",
                           str(tmp)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
    for obj in objs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed\n"
                           + link.stdout.decode(errors="replace"))
    os.replace(tmp, so)
    return so


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
