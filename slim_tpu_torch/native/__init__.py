"""Host runtime of the port: ctypes bindings of ``slimrt.cpp`` (the C ABI
and semantics of the JAX package's native runtime).

The library is built at first use, never at import, with ``g++ -O3
-march=native -fopenmp -shared -fPIC -std=c++17`` into ``build/native/``
beside the package (listed in .gitignore).  Its name carries a hash of
the source, the flags and the host CPU's model and instruction-set flags,
so a library built for one CPU (``-march=native``) is never loaded on
another.  Processes that build at once (test workers, the ranks of a
world) serialise on an ``fcntl.flock`` of ``build/native/lock``, so one
builds and the others load its library; the building process writes a
file tagged with its pid and gives it the final name by ``os.replace``, so
no process loads a half-written library.  The kernel drops a flock when
its holder dies, so a cut build leaves no stale lock.

:func:`available` is False only when no C++ compiler is found.  A
compiler that is present but fails to build, or a library that fails to
load, raises with the compiler's or the loader's message.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..types import CSR

SRC = Path(__file__).resolve().parent / "slimrt.cpp"
BUILD_DIR = SRC.parent.parent.parent / "build" / "native"
CXX = "g++"
FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
         "-std=c++17"]

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_I32, _I64, _F64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_double

# C entry points: (restype, argtypes), as declared in slimrt.cpp
_SIGNATURES = {
    "slim_cd_learn": (_I64, [
        _I32, _I32, _i64p, _i32p, _f32p, _F64, _F64, _F64, _I32, _I32,
        ctypes.c_uint64, _I32, ctypes.POINTER(_i64p), ctypes.POINTER(_i32p),
        ctypes.POINTER(_f32p), _f64p, _f64p]),
    "slim_gram_dense": (None, [_I32, _I32, _i64p, _i32p, _f32p, _f32p, _I64,
                               _I32]),
    "slim_predict_topn": (None, [_I32, _I32, _i64p, _i32p, _f32p, _i64p,
                                 _i32p, _f32p, _I32, _i32p, _f32p, _i32p,
                                 _I32]),
    "slim_parse_tokens": (_I64, [ctypes.c_char_p, _I64, _f64p, _I64, _i64p,
                                 _i64p]),
    "slim_csr_from_blocks": (None, [_I32, ctypes.POINTER(_i32p),
                                    ctypes.POINTER(_i32p),
                                    ctypes.POINTER(_f32p), _i64p, _I32,
                                    _i64p, _i32p, _f32p]),
    "slim_free": (None, [ctypes.c_void_p]),
}

_lock = threading.Lock()
_lib = None


def compiler() -> str | None:
    """The C++ compiler's path, or None when there is none."""
    return shutil.which(CXX)


def _cpuinfo(key: str) -> str:
    """The first ``key`` line of /proc/cpuinfo ("" where there is none)."""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(key):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


def cpu_model() -> str:
    """The host CPU's model name."""
    return _cpuinfo("model name") or platform.processor() \
        or platform.machine()


def library_path() -> Path:
    """Where the library for this source, these flags and this CPU lives:
    the CPU by its model and its instruction-set flags, since a virtual
    machine may give several CPUs one generic model name."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(cpu_model().encode())
    h.update(_cpuinfo("flags").encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libslimrt_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile slimrt.cpp unless the library for its hash exists (module
    docstring); raises with the compiler's stderr when it fails."""
    so = library_path()
    if so.exists():
        return so
    cxx = compiler()
    if cxx is None:
        raise RuntimeError(f"no C++ compiler ({CXX}) to build {SRC.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():          # another process built it meanwhile
            return so
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{CXX} failed to build {SRC.name}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, so)
    return so


def lib():
    """The loaded library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                handle = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"cannot load {path}: {e}") from e
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = handle
        return _lib


def available() -> bool:
    """True when the library is loaded or can be built; False only when
    no C++ compiler is found.  A failed build or load raises."""
    if _lib is None and not library_path().exists() and compiler() is None:
        return False
    lib()
    return True


def _ptr(a, t):
    return None if a is None else a.ctypes.data_as(t)


def _c(a, dt):
    return None if a is None else np.ascontiguousarray(a, dtype=dt)


def cd_learn(train: CSR, l1r=1.0, l2r=1.0, optTol=1e-7, maxniters=10000,
             shuffle=True, seed=0, nthreads=0):
    """The OpenMP CD solver over all item columns.  Returns (model CSR,
    err, obj) with the JAX package's semantics: the same screen, caps and
    objective; each thread seeds its own visit-order generator, so only
    ``shuffle=False`` gives the same model at any thread count.
    ``nthreads`` 0: OpenMP's default."""
    h = lib()
    train = train.infer_ncols()
    csc = train.transpose()
    colptr = _c(csc.indptr, np.int64)
    colind = _c(csc.indices, np.int32)
    colval = _c(csc.data, np.float32)
    out_ptr, out_ind, out_val = _i64p(), _i32p(), _f32p()
    err, obj = ctypes.c_double(), ctypes.c_double()
    tnnz = h.slim_cd_learn(
        train.nrows, train.ncols, _ptr(colptr, _i64p), _ptr(colind, _i32p),
        _ptr(colval, _f32p), l1r, l2r, optTol, int(maxniters),
        int(bool(shuffle)), int(seed), int(nthreads), ctypes.byref(out_ptr),
        ctypes.byref(out_ind), ctypes.byref(out_val), ctypes.byref(err),
        ctypes.byref(obj))
    if tnnz < 0:
        raise RuntimeError("slim_cd_learn: out of memory")
    n = train.ncols
    try:
        cptr = np.ctypeslib.as_array(out_ptr, shape=(n + 1,)).copy()
        cind = np.ctypeslib.as_array(out_ind, shape=(max(tnnz, 1),))[
            :tnnz].copy()
        cval = np.ctypeslib.as_array(out_val, shape=(max(tnnz, 1),))[
            :tnnz].copy()
    finally:
        for p in (out_ptr, out_ind, out_val):
            h.slim_free(p)
    # the solver's CSC (column j = target j) -> model CSR (rows = rated item)
    model = CSR.from_arrays(n, n, cptr, cind, cval).transpose()
    return (CSR.from_arrays(n, n, model.indptr, model.indices, model.data),
            err.value, obj.value)


def parse_tokens(raw: bytes):
    """Tokenise whitespace-separated numbers with ``strtod``.  Returns
    (tokens float64, tokens per line int64).  Differs from splitting:
    a lone ``\\r`` is whitespace (only ``\\n`` ends a line), and a
    character ``strtod`` cannot start a number with is skipped where
    ``float()`` would raise."""
    h = lib()
    max_tokens = len(raw) // 2 + 2
    out = np.empty(max_tokens, dtype=np.float64)
    breaks = np.empty(raw.count(b"\n") + 2, dtype=np.int64)
    nlines = ctypes.c_int64()
    ntok = h.slim_parse_tokens(raw, len(raw), _ptr(out, _f64p), max_tokens,
                               _ptr(breaks, _i64p), ctypes.byref(nlines))
    per_line = np.diff(np.concatenate(([0], breaks[:nlines.value])))
    return out[:ntok], per_line.astype(np.int64)


def gram_dense(train: CSR, pad_to=None, nthreads=0) -> np.ndarray:
    """Threaded sparse Gram AᵀA into a dense (pad, pad) float32 array
    (zero padding), each entry accumulated in float32."""
    h = lib()
    train = train.infer_ncols()
    n = train.ncols
    ldg = pad_to if pad_to is not None else n
    if ldg < n:
        raise ValueError(f"pad_to {ldg} < {n} columns")
    out = np.zeros((ldg, ldg), dtype=np.float32)
    rowptr = _c(train.indptr, np.int64)
    rowind = _c(train.indices, np.int32)
    rowval = _c(train.data, np.float32)
    h.slim_gram_dense(train.nrows, n, _ptr(rowptr, _i64p),
                      _ptr(rowind, _i32p), _ptr(rowval, _f32p),
                      _ptr(out, _f32p), ldg, int(nthreads))
    return out


def predict_topn(model: CSR, hist: CSR, nrcmds=10, nthreads=0):
    """Threaded per-user top-N (reference predict.c:40-58): score(k) =
    Σ_{i in history} rating_i · W[i, k], history excluded, only scores > 0
    kept.  Returns (ids (nusers, nrcmds) int32 with -1 padding, scores
    float32, counts int32).  Equal scores keep the first-touched id first
    (the device routes put the lowest id first)."""
    h = lib()
    n = max(model.nrows, model.ncols, hist.ncols)
    nusers = hist.nrows
    wptr = _c(model.indptr, np.int64)
    if model.nrows < n:   # items without a model row score nothing
        wptr = np.concatenate(
            [wptr, np.full(n - model.nrows, wptr[-1], dtype=np.int64)])
    wind = _c(model.indices, np.int32)
    wval = _c(model.values(), np.float32)
    hptr = _c(hist.indptr, np.int64)
    hind = _c(hist.indices, np.int32)
    hval = _c(hist.data, np.float32)
    ids = np.empty((nusers, nrcmds), dtype=np.int32)
    scores = np.empty((nusers, nrcmds), dtype=np.float32)
    counts = np.empty(nusers, dtype=np.int32)
    h.slim_predict_topn(nusers, n, _ptr(wptr, _i64p), _ptr(wind, _i32p),
                        _ptr(wval, _f32p), _ptr(hptr, _i64p),
                        _ptr(hind, _i32p), _ptr(hval, _f32p), nrcmds,
                        _ptr(ids, _i32p), _ptr(scores, _f32p),
                        _ptr(counts, _i32p), int(nthreads))
    return ids, scores, counts


def csr_from_blocks(rows_list, cols_list, vals_list, nrows: int):
    """Threaded CSR assembly of COO fragments with no repeated (row, col)
    pair (the model harvest's contract).  Returns (indptr int64, indices
    int32, data float32), each row's columns ascending: entry for entry
    ``CSR.from_ijv(..., no_duplicates=True)`` of the concatenation."""
    h = lib()
    rows = [_c(r, np.int32) for r in rows_list]
    cols = [_c(c, np.int32) for c in cols_list]
    vals = [_c(v, np.float32) for v in vals_list]
    sizes = np.array([r.size for r in rows], dtype=np.int64)
    if not (len(rows) == len(cols) == len(vals)) or any(
            c.size != s or v.size != s for c, v, s in zip(cols, vals, sizes)):
        raise ValueError("fragments of unequal lengths")
    for r in rows:
        if r.size and (r.min() < 0 or r.max() >= nrows):
            raise ValueError(f"row id outside [0, {nrows})")
    total = int(sizes.sum())
    indptr = np.zeros(nrows + 1, dtype=np.int64)
    indices = np.empty(total, dtype=np.int32)
    data = np.empty(total, dtype=np.float32)
    if total == 0:
        return indptr, indices, data
    nfrag = len(rows)
    rp = (_i32p * nfrag)(*[_ptr(r, _i32p) for r in rows])
    cp = (_i32p * nfrag)(*[_ptr(c, _i32p) for c in cols])
    vp = (_f32p * nfrag)(*[_ptr(v, _f32p) for v in vals])
    h.slim_csr_from_blocks(nfrag, rp, cp, vp, _ptr(sizes, _i64p), nrows,
                           _ptr(indptr, _i64p), _ptr(indices, _i32p),
                           _ptr(data, _f32p))
    return indptr, indices, data
