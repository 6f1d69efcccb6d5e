"""MatrixMarket coordinate I/O.

Counterpart of the JAX package's io/mtx.py (host code; no device and no
kernel is involved).  Parity with the reference reader:
  * real / integer / pattern / complex fields (complex keeps the real part);
  * symmetric / skew-symmetric / hermitian inputs are generalized (both
    triangles emitted);
  * the native reader itself is multithreaded.

Fast path: the C++ parser csrc/mtx_reader.cpp at the repository root, through
ctypes.  This package builds it (and csrc/result_writer.cpp) lazily with g++
into its own build directory (ops/_build.py), never beside the sources, so
its build cannot collide with another package's build of the same files.
Fallback when g++ or the sources are missing: a vectorized numpy parser.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from pem_spgemm_tpu_torch.formats.coo import COOMatrix
from pem_spgemm_tpu_torch.ops import _build

_CSRC = os.path.join(os.path.dirname(_build.PKG_DIR), "csrc")

_native = {}            # source stem -> ctypes.CDLL, or None once it failed
_lib_lock = threading.Lock()

_FIELDS = {0: "real", 1: "integer", 2: "pattern", 3: "complex"}
_SYMS = {0: "general", 1: "symmetric", 2: "skew-symmetric", 3: "hermitian"}


def _declare_reader(lib) -> None:
    lib.mtx_read_header.restype = ctypes.c_int
    lib.mtx_read_header.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.mtx_read_data.restype = ctypes.c_int64
    lib.mtx_read_data.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int]


def _declare_writer(lib) -> None:
    lib.write_result_files.restype = ctypes.c_int64
    lib.write_result_files.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int]


def _get_native(stem: str, declare) -> Optional[ctypes.CDLL]:
    """Lazily build + load csrc/<stem>.cpp; None if unavailable (no source,
    no g++, or a failed build), decided once a process."""
    with _lib_lock:
        if stem not in _native:
            src = os.path.join(_CSRC, f"{stem}.cpp")
            try:
                so_path = _build.compile_shared(
                    ["g++", *_build.GXX_FLAGS], src, timeout=120)
                _native[stem] = _build.load(so_path, declare)
            except (RuntimeError, OSError, subprocess.SubprocessError):
                _native[stem] = None
        return _native[stem]


def _read_native(path: str, nthreads: int):
    lib = _get_native("mtx_reader", _declare_reader)
    if lib is None:
        return None
    nr = ctypes.c_int64(); nc = ctypes.c_int64(); nnz = ctypes.c_int64()
    field = ctypes.c_int(); sym = ctypes.c_int()
    err = lib.mtx_read_header(path.encode(), ctypes.byref(nr),
                              ctypes.byref(nc), ctypes.byref(nnz),
                              ctypes.byref(field), ctypes.byref(sym))
    if err != 0:
        return None
    cap = max(1, nnz.value)
    rows = np.empty(cap, np.int32)
    cols = np.empty(cap, np.int32)
    vals = np.empty(cap, np.float64)
    n = lib.mtx_read_data(path.encode(), rows, cols, vals, cap, nthreads)
    if n < 0:
        return None
    if n < nnz.value:
        raise ValueError(
            f"{path}: truncated data section ({n} of {nnz.value} entries)")
    return (rows[:n], cols[:n], vals[:n], (nr.value, nc.value),
            _FIELDS.get(field.value, "real"), _SYMS.get(sym.value, "general"))


def _read_python(path: str):
    """Vectorized numpy fallback parser."""
    with open(path, "rb") as f:
        banner = f.readline().decode("ascii", "replace").lower()
        if not banner.startswith("%%matrixmarket"):
            raise ValueError(f"{path}: not a MatrixMarket file")
        if "coordinate" not in banner:
            raise ValueError(f"{path}: only coordinate format supported")
        field = ("complex" if "complex" in banner else
                 "integer" if "integer" in banner else
                 "pattern" if "pattern" in banner else "real")
        sym = ("skew-symmetric" if "skew-symmetric" in banner else
               "hermitian" if "hermitian" in banner else
               "symmetric" if "symmetric" in banner else "general")
        line = f.readline()
        while line.startswith(b"%"):
            line = f.readline()
        nrows, ncols, nnz = (int(t) for t in line.split()[:3])
        body = f.read()
    ncol_tokens = {"pattern": 2, "complex": 4}.get(field, 3)
    data = np.array(body.split(), dtype=np.float64)
    if len(data) < nnz * ncol_tokens:
        raise ValueError(f"{path}: truncated data section")
    data = data[:nnz * ncol_tokens].reshape(nnz, ncol_tokens)
    rows = data[:, 0].astype(np.int32) - 1
    cols = data[:, 1].astype(np.int32) - 1
    if field == "pattern":
        vals = np.ones(nnz, np.float64)
    else:
        vals = data[:, 2]  # complex: real part only, as the reference
    return rows, cols, vals, (nrows, ncols), field, sym


def _generalize_symmetry(rows, cols, vals, sym: str):
    """Emit both triangles for symmetric-family matrices."""
    if sym == "general":
        return rows, cols, vals
    off = rows != cols
    mr, mc, mv = rows[off], cols[off], vals[off]
    if sym == "skew-symmetric":
        mv = -mv
    return (np.concatenate([rows, mc]), np.concatenate([cols, mr]),
            np.concatenate([vals, mv]))


def read_matrix_market(path: str, dtype=np.float64, nthreads: int = 0,
                       native: bool = True) -> COOMatrix:
    """Read a .mtx file into host COO triplets (0-based, symmetry expanded)."""
    if nthreads <= 0:
        nthreads = min(8, os.cpu_count() or 1)
    out = _read_native(path, nthreads) if native else None
    if out is None:
        out = _read_python(path)
    rows, cols, vals, shape, _field, sym = out
    rows, cols, vals = _generalize_symmetry(rows, cols, vals, sym)
    return COOMatrix(rows, cols, vals.astype(dtype, copy=False), shape)


def write_matrix_market(path: str, m: COOMatrix) -> None:
    """Write COO triplets as a general real coordinate .mtx file."""
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{m.shape[0]} {m.shape[1]} {m.nnz}\n")
        for r, c, v in zip(m.rows, m.cols, m.vals):
            f.write(f"{int(r) + 1} {int(c) + 1} {v:.17g}\n")


def save_result_files(outdir: str, m: COOMatrix, prefix: str = "SPGEMM_RESULT",
                      native: bool = True):
    """Dump a result in the reference's four-file text layout:
    <prefix>_{NNZ,ROWS,COLS,VALS}.txt, values at max_digits10 precision.
    The native writer formats slices in parallel (csrc/result_writer.cpp),
    with numpy savetxt as fallback.
    """
    os.makedirs(outdir, exist_ok=True)
    paths = {k: os.path.join(outdir, f"{prefix}_{k}.txt")
             for k in ("NNZ", "ROWS", "COLS", "VALS")}
    lib = _get_native("result_writer", _declare_writer) if native else None
    if lib is not None:
        rows = np.ascontiguousarray(m.rows, np.int32)
        cols = np.ascontiguousarray(m.cols, np.int32)
        vals = np.ascontiguousarray(m.vals, np.float64)
        n = lib.write_result_files(
            outdir.encode(), prefix.encode(), rows, cols, vals,
            np.int64(m.nnz), min(8, os.cpu_count() or 1))
        if n == m.nnz:
            return paths
    with open(paths["NNZ"], "w") as f:
        f.write(f"{m.nnz}\n")
    np.savetxt(paths["ROWS"], m.rows, fmt="%d")
    np.savetxt(paths["COLS"], m.cols, fmt="%d")
    np.savetxt(paths["VALS"], m.vals, fmt="%.17f")
    return paths
