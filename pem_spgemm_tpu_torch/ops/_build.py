"""Build-at-first-use of the port's native sources.

One place for what every native source of the package needs: find the
compiler, name the shared library after a hash of the source (so an edited
source is rebuilt and a stale library is never loaded), compile into
``pem_spgemm_tpu_torch/build/`` through a temporary file that is renamed
into place (concurrent builds cannot expose a half-written library), and
load it with ctypes.  CUDA sources (csrc/*.cu) have a plain C interface and
are compiled by nvcc for sm_90a; the host C++ sources of the .mtx reader and
the result writer are compiled by g++.

A failed build raises: nothing here falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

# every CUDA source of the package, by stem (csrc/<stem>.cu)
CUDA_SOURCES = ("segment_sort", "dia_multiply", "macro_accumulate",
                "row_copy", "tile16_accumulate")

_loaded = {}            # library path -> ctypes.CDLL
_cuda = {}              # CUDA source stem -> ctypes.CDLL


def cuda_source(stem: str) -> str:
    return os.path.join(CSRC_DIR, f"{stem}.cu")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "pem_spgemm_tpu_torch/csrc/*.cu at first use")


def library_path(source: str) -> str:
    """build/lib<stem>_<hash of the source>.so"""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def _start(compiler_cmd, source, so_path):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = [*compiler_cmd, "-o", tmp, source]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, cmd, tmp


def _finish(proc, cmd, tmp, so_path, timeout=None) -> str:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"build timed out: {' '.join(cmd)}")
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"build failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{out}\n{err}")
    os.replace(tmp, so_path)
    return err


def compile_shared(compiler_cmd, source, timeout=None) -> str:
    """Path of the shared library of ``source``, compiling it if this exact
    source has not been compiled yet.  Raises RuntimeError on failure and
    FileNotFoundError if the compiler is missing."""
    so_path = library_path(source)
    if not os.path.isfile(so_path):
        _finish(*_start(compiler_cmd, source, so_path), so_path, timeout)
    return so_path


def load(so_path: str, declare=None) -> ctypes.CDLL:
    """ctypes.CDLL of ``so_path``, loaded once; ``declare(lib)`` sets the
    argument and result types of its functions on that first load."""
    if so_path not in _loaded:
        lib = ctypes.CDLL(so_path)
        if declare is not None:
            declare(lib)
        _loaded[so_path] = lib
    return _loaded[so_path]


def cuda_library(stem: str, declare) -> ctypes.CDLL:
    """The loaded library of csrc/<stem>.cu (built now if it is not).  The
    source is hashed once a process: every later call is a dict lookup, as
    the wrappers call this at each launch."""
    if stem not in _cuda:
        _cuda[stem] = load(compile_shared([find_nvcc(), *NVCC_FLAGS],
                                          cuda_source(stem)), declare)
    return _cuda[stem]


def build_kernels(verbose: bool = False) -> float:
    """Build every CUDA source that is not built for its current content,
    one nvcc per source, all started together.  The wrappers load their
    library at their first launch.

    Returns the seconds the builds took (0.0 when every library was already
    there).  With ``verbose`` ptxas prints each kernel's registers and
    shared memory.  A failed build raises.
    """
    todo = []
    t0 = time.perf_counter()
    for stem in CUDA_SOURCES:
        src = cuda_source(stem)
        so_path = library_path(src)
        if not os.path.isfile(so_path):
            cmd = [find_nvcc(), *NVCC_FLAGS]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            todo.append(_start(cmd, src, so_path) + (so_path,))
    errors = []
    for job in todo:                    # wait for all before raising
        try:
            log = _finish(*job)
            if verbose:
                print(log, flush=True)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0 if todo else 0.0
