"""Readers/writers for the rating-matrix file formats the reference accepts.

Format parity (reference ``cmdline_learn.c:38-43`` maps the CLI names):

* ``csr``   - one line per row, whitespace ``col val`` pairs, 0-based columns
              (the reference programs call ``gk_csr_Read(..., numbering=0)``,
              slim_learn.c:27).
* ``csrnv`` - csr without values (implicit 1.0 ratings).
* ``cluto`` - header line ``nrows ncols nnz`` then csr rows with **1-based**
              column indices and values.
* ``ijv``   - one ``row col val`` triplet per line, 0-based.
* ``binrow``- binary row-major dump, used for ``SLIM_WriteModel``/
              ``SLIM_ReadModel`` (api.c:174-194).  GKlib's exact on-disk
              layout isn't vendored here (the submodule is empty in the
              reference snapshot), so we define a self-describing layout:
              magic ``SLIMTPU1``, int32 nrows/ncols/has_vals, int64 nnz,
              int64 indptr, int32 indices, float32 data.

Byte-compatible with the JAX package's slim_tpu.io (same parsers and
writers).  Text files are tokenised by the native runtime's ``strtod``
tokeniser when a C++ compiler is found, as in the JAX package, else by
numpy; the two differ only on malformed text (:func:`_tokenise_file`).
"""

from __future__ import annotations

import struct

import numpy as np

from .. import native
from ..types import CSR

FORMATS = ("csr", "csrnv", "cluto", "ijv", "binrow")

_MAGIC = b"SLIMTPU1"


# --------------------------------------------------------------------- #
# dispatch
# --------------------------------------------------------------------- #
def read_matrix(path: str, fmt: str = "csr", readvals: bool = True,
                numbering: int = 0) -> CSR:
    """Read a matrix in any supported format (reference gk_csr_Read)."""
    if fmt == "csr":
        return read_csr(path, readvals=readvals, numbering=numbering)
    if fmt == "csrnv":
        return read_csr(path, readvals=False, numbering=numbering)
    if fmt == "cluto":
        return read_cluto(path)
    if fmt == "ijv":
        return read_ijv(path, numbering=numbering)
    if fmt == "binrow":
        return read_binrow(path)
    raise ValueError(f"unknown matrix format {fmt!r}; choose from {FORMATS}")


def write_matrix(mat: CSR, path: str, fmt: str = "csr", writevals: bool = True,
                 numbering: int = 0) -> None:
    if fmt == "csr":
        write_csr(mat, path, writevals=writevals, numbering=numbering)
    elif fmt == "csrnv":
        write_csr(mat, path, writevals=False, numbering=numbering)
    elif fmt == "cluto":
        write_cluto(mat, path)
    elif fmt == "ijv":
        write_ijv(mat, path, numbering=numbering)
    elif fmt == "binrow":
        write_binrow(mat, path)
    else:
        raise ValueError(f"unknown matrix format {fmt!r}; choose from {FORMATS}")


# --------------------------------------------------------------------- #
# text csr
# --------------------------------------------------------------------- #
def _tokenise_file(path):
    """Return (all tokens f64, tokens-per-line i64): the native tokeniser
    when available (``native.parse_tokens``: a lone ``\\r`` does not end
    a line there, and a character no number starts with is skipped where
    numpy raises), numpy otherwise."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if native.available():
        return native.parse_tokens(raw)
    return _tokenise_numpy(raw)


def _tokenise_numpy(raw: bytes):
    """(all tokens f64, tokens-per-line i64) of ``raw`` by splitting."""
    lines = raw.splitlines()
    all_tok = np.array((b" ".join(lines)).split(), dtype=np.float64) \
        if lines else np.zeros(0)
    per_row = np.array([len(l.split()) for l in lines], dtype=np.int64)
    return all_tok, per_row


def read_csr(path: str, readvals: bool = True, numbering: int = 0) -> CSR:
    all_tok, per_row = _tokenise_file(path)
    nrows = len(per_row)
    if readvals:
        if np.any(per_row % 2):
            raise ValueError(f"{path}: odd token count on a row in csr format")
        nnz_per_row = per_row // 2
        pairs = all_tok.reshape(-1, 2)
        indices = pairs[:, 0].astype(np.int64) - numbering
        data = pairs[:, 1].astype(np.float32)
    else:
        nnz_per_row = per_row
        indices = all_tok.astype(np.int64) - numbering
        data = None
    if indices.size and indices.min() < 0:
        raise ValueError(
            f"{path}: column id below {numbering} (csr files are "
            f"{numbering}-indexed here; check the format / numbering)")
    indptr = np.zeros(nrows + 1, dtype=np.int64)
    np.cumsum(nnz_per_row, out=indptr[1:])
    ncols = int(indices.max()) + 1 if indices.size else 0
    return CSR.from_arrays(nrows, ncols, indptr, indices.astype(np.int32),
                           data).sum_duplicate_entries()


def _format_pairs(indices, vals, numbering):
    """Vectorised '<ind> <val>' token column (fast path for big writes)."""
    ind_s = np.char.mod("%d", indices.astype(np.int64) + numbering)
    if vals is None:
        return ind_s
    val_s = np.char.mod("%.6g", vals)
    return np.char.add(np.char.add(ind_s, " "), val_s)


def _write_rows(fh, tokens, indptr):
    """Join tokens into one line per row and stream out."""
    nrows = len(indptr) - 1
    block = 4096
    for r0 in range(0, max(nrows, 1), block):
        r1 = min(r0 + block, nrows)
        parts = []
        for r in range(r0, r1):
            s, e = int(indptr[r]), int(indptr[r + 1])
            parts.append(" ".join(tokens[s:e]))
        fh.write("\n".join(parts))
        fh.write("\n")


def write_csr(mat: CSR, path: str, writevals: bool = True, numbering: int = 0) -> None:
    tokens = _format_pairs(mat.indices, mat.values() if writevals else None,
                           numbering)
    with open(path, "w") as fh:
        _write_rows(fh, tokens, mat.indptr)


# --------------------------------------------------------------------- #
# cluto
# --------------------------------------------------------------------- #
def read_cluto(path: str) -> CSR:
    tok, per_line = _tokenise_file(path)
    if len(per_line) < 1 or per_line[0] < 3:
        raise ValueError(f"{path}: missing cluto header")
    nrows, ncols, nnz = int(tok[0]), int(tok[1]), int(tok[2])
    hdr = int(per_line[0])
    all_tok = tok[hdr:]
    per_row = per_line[1:1 + nrows]
    if np.any(per_row % 2):
        raise ValueError(f"{path}: odd token count on a row in cluto format")
    nnz_per_row = per_row // 2
    pairs = all_tok.reshape(-1, 2)
    indices = pairs[:, 0].astype(np.int64) - 1  # cluto is 1-based
    data = pairs[:, 1].astype(np.float32)
    indptr = np.zeros(nrows + 1, dtype=np.int64)
    np.cumsum(nnz_per_row, out=indptr[1:])
    if indptr[-1] != nnz:
        raise ValueError(f"{path}: header says nnz={nnz} but file has {indptr[-1]}")
    return CSR.from_arrays(nrows, ncols, indptr, indices.astype(np.int32),
                           data).sum_duplicate_entries()


def write_cluto(mat: CSR, path: str) -> None:
    tokens = _format_pairs(mat.indices, mat.values(), 1)  # cluto is 1-based
    with open(path, "w") as fh:
        fh.write(f"{mat.nrows} {mat.ncols} {mat.nnz}\n")
        _write_rows(fh, tokens, mat.indptr)


# --------------------------------------------------------------------- #
# ijv
# --------------------------------------------------------------------- #
def read_ijv(path: str, numbering: int = 0) -> CSR:
    tok = np.loadtxt(path, dtype=np.float64, ndmin=2)
    if tok.size == 0:
        return CSR.empty(0, 0)
    rows = tok[:, 0].astype(np.int64) - numbering
    cols = tok[:, 1].astype(np.int64) - numbering
    if rows.size and (rows.min() < 0 or cols.min() < 0):
        raise ValueError(
            f"{path}: negative user/item id after applying "
            f"numbering={numbering} (ijv is 0-indexed here)")
    vals = tok[:, 2].astype(np.float32) if tok.shape[1] > 2 else \
        np.ones(len(rows), np.float32)
    return CSR.from_ijv(rows, cols, vals)


def write_ijv(mat: CSR, path: str, numbering: int = 0) -> None:
    vals = mat.values()
    rows = np.repeat(np.arange(mat.nrows, dtype=np.int64),
                     mat.row_nnz().astype(np.int64))
    lines = np.char.add(
        np.char.add(np.char.mod("%d", rows + numbering), " "),
        _format_pairs(mat.indices, vals, numbering))
    with open(path, "w") as fh:
        fh.write("\n".join(lines.tolist()))
        if len(lines):
            fh.write("\n")


# --------------------------------------------------------------------- #
# binary row format (model store)
# --------------------------------------------------------------------- #
def read_binrow(path: str) -> CSR:
    with open(path, "rb") as fh:
        magic = fh.read(8)
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a slim_tpu binrow file")
        nrows, ncols, has_vals = struct.unpack("<iii", fh.read(12))
        (nnz,) = struct.unpack("<q", fh.read(8))
        indptr = np.fromfile(fh, dtype=np.int64, count=nrows + 1)
        indices = np.fromfile(fh, dtype=np.int32, count=nnz)
        data = np.fromfile(fh, dtype=np.float32, count=nnz) if has_vals else None
    return CSR.from_arrays(nrows, ncols, indptr, indices,
                           data).sum_duplicate_entries()


def write_binrow(mat: CSR, path: str) -> None:
    with open(path, "wb") as fh:
        fh.write(_MAGIC)
        fh.write(struct.pack("<iii", mat.nrows, mat.ncols,
                             0 if mat.data is None else 1))
        fh.write(struct.pack("<q", mat.nnz))
        mat.indptr.astype(np.int64).tofile(fh)
        mat.indices.astype(np.int32).tofile(fh)
        if mat.data is not None:
            mat.data.astype(np.float32).tofile(fh)


def read_l12file(path: str):
    """Parse an mselect l1/l2 pair file (reference slim_mselect.c:99-101)."""
    pairs = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 2:
                pairs.append((float(parts[0]), float(parts[1])))
    return pairs
