"""DIA multiply kernels: wrappers of csrc/dia_multiply.cu.

Counterpart of the JAX package's ops/pallas_dia.py (``dia_multiply_pallas``
and ``pallas_dia_mode``).  Two entries, one CUDA source (built with nvcc at
first use and bound with ctypes by ops/_build.py):

  mode="dense"   the stencil kernel: B's offsets are a dense integer range
                 and ``dc_list`` is the dense sum range, so the B band of
                 every product is arithmetic on the row index;
  mode="pairs"   any offset sets: the products of each C row come from a
                 small CSR table of (A band, B band, shift) triples.

Both compute ``C[d1 + d2][i] += A[d1][i] * B[d2][i + d1]`` over all band
pairs, in ascending A-band order per C element, and the same sum over the
0/1 masks (float32 structural counts).  Each mode has a float32 entry and a
float64 entry (the f64 parity mode, rounding each product and sum as the
plain version does); the bands' dtype picks it.
``values_only=True`` launches the variant without the mask algebra and
returns ``None`` for the counts.  The
dense entries stage a window of B in shared memory (the float64 one is the
float32 kernel on 8-byte words, with its own thread geometry):
``dense_launch`` gives the block shape and shared-memory layout for a word
size, ``dense_chunks`` the band chunks.
The pairs entry stages its column range of the A bands and the pair tables:
``pairs_launch`` gives its grid and what is staged.

Dispatch is by the tensors' device and nothing else: CUDA tensors launch the
kernel (or raise, if the build or the launch fails); CPU tensors take the
plain PyTorch version, ``ops.dia._dia_multiply_torch``.  Each wrapper call
adds one to its entry in ``LAUNCHES`` where it launches its kernel, and
nowhere else: an output with no elements returns without a launch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pem_spgemm_tpu_torch.ops import _build
from pem_spgemm_tpu_torch.ops.dia import _dia_multiply_torch, _plan_maps

SOURCE = _build.cuda_source("dia_multiply")
# The dense entries' geometry by word size (the .cu's Dense<float>,
# Dense<double>): C rows and columns a thread, threads a block at most.
DENSE_GEOMETRY = {4: dict(rows=8, cols=4, threads=256),
                  8: dict(rows=4, cols=4, threads=256)}
ROWS = DENSE_GEOMETRY[4]["rows"]    # the float32 entry's
COLS = DENSE_GEOMETRY[4]["cols"]
MAX_ROW_BLOCKS = 8          # row blocks a thread block, at most
MAX_COL_BLOCKS = 64         # column blocks a thread block, at most
COPY_WIDTH = 32             # window columns a pass of the staging copies
SMEM_BUDGET = 112 * 1024    # bytes a block of either entry: two an SM
PAIR_THREADS = 256          # threads a block of the pairs entry (the .cu's)
PAIR_COLS = 4               # columns a thread of the pairs entry
PAIR_L = PAIR_THREADS * PAIR_COLS   # columns a block of the pairs entry
PAIRS_MIN_BLOCKS = 264      # pairs-entry blocks wanted: two an SM of 132

# kernel launches per entry (plain-version calls are not counted)
LAUNCHES = {"dia_multiply_dense": 0, "dia_multiply_pairs": 0,
            "dia_multiply_dense_f64": 0, "dia_multiply_pairs_f64": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _declare(lib) -> None:
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dia_multiply_dense_f32.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci,
                                           ll, ll, ll, ci, ci, ci, ci, ci,
                                           ci, ci, vp]
    lib.dia_multiply_dense_f32.restype = ci
    lib.dia_multiply_pairs_f32.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci,
                                           ci, ci, ci, ll, ll, ll, ci, ci,
                                           ci, ci, vp]
    lib.dia_multiply_pairs_f32.restype = ci
    lib.dia_multiply_dense_f64.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci,
                                           ll, ll, ll, ci, ci, ci, ci, ci,
                                           ci, ci, vp]
    lib.dia_multiply_dense_f64.restype = ci
    lib.dia_multiply_pairs_f64.argtypes = [vp, vp, vp, vp, vp, vp, ci, ll,
                                           ll, ll, vp]
    lib.dia_multiply_pairs_f64.restype = ci


def _library():
    return _build.cuda_library("dia_multiply", _declare)


# --------------------------------------------------------------------------
# mode choice

def dense_qualifies(offs_a, offs_b, dc_list) -> bool:
    """The dense entry's structural precondition: B's offsets form a dense
    integer range and the plan's C offsets are the dense sum range.  The
    kernel maps product (d1, d2) to row (d1 + d2) - dc_list[0]; a gapped
    offs_a (spacing wider than B's range) leaves gaps in dc_list, and that
    mapping would misindex the plan's rows."""
    if not offs_a or not offs_b:
        return False
    dense_b = max(offs_b) - min(offs_b) + 1 == len(offs_b)
    dc_dense = (max(offs_a) + max(offs_b)) - (min(offs_a) + min(offs_b)) + 1
    return dense_b and len(dc_list) == dc_dense


def dia_mode(offs_a, offs_b, dc_list):
    """Which kernel entry a plan uses: 'dense' | 'pairs' (None for empty
    offset sets).

    Only the structural precondition decides: 'dense' where it holds, else
    'pairs', which takes any offset sets.  There is no profitability gate:
    bands on the GPU always launch a kernel."""
    if not offs_a or not offs_b:
        return None
    return "dense" if dense_qualifies(offs_a, offs_b, dc_list) else "pairs"


# --------------------------------------------------------------------------
# the dense entry's launch shape

def _pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def dense_chunks(offs_a, kc: int):
    """[(kb, ke)]: the A-band chunks the dense kernel stages, in order: at
    most kc bands whose offsets span less than kc (the .cu's chunk_end)."""
    offs_a = tuple(offs_a)
    out, kb = [], 0
    while kb < len(offs_a):
        ke = kb + 1
        while (ke < len(offs_a) and ke - kb < kc
               and offs_a[ke] - offs_a[kb] < kc):
            ke += 1
        out.append((kb, ke))
        kb = ke
    return out


def dense_launch(offs_a, d2n: int, dcn: int, word: int = 4):
    """The dense entry's launch shape for A's offsets, B's d2n bands, dcn
    C rows and ``word``-byte words (4: the float32 entry, 8: the float64
    one; the same for the values-only variants).

    A thread owns rows x cols C elements (``DENSE_GEOMETRY[word]``); a block
    2^tr_log2 row blocks (enough for every C row, at most threads / 32) x
    tc_n column blocks (at most 64, at most ``threads`` threads, so at
    least 32), so L = tc_n * cols columns; threads take column blocks
    first, so the lanes of a warp share their rows and skip or take a band
    together.  Per
    chunk of at most kc A bands spanning less than kc (``dense_chunks``),
    the block stages the A chunk (a_rows x L words: a_rows the most bands a
    chunk has) and, from word b_off, the B window: at most rows_cap rows
    (the B rows the block's C rows reach, plus rows - 1 zero rows on each
    side) of at most cols_cap = L + the widest chunk's offset span columns,
    each row a ring of s words (a multiple of 32 holding cols_cap and
    rows_cap + 3 words) rotated by its row index, which keeps the .cu's
    positions below 2 s.  kc is the largest power of two up to 128 whose
    shared memory fits in SMEM_BUDGET (fewer chunks stage fewer windows).
    The grid is one-dimensional: grid_y row blocks of each column range,
    neighbours.  Returns a dict; raises ValueError where even kc = 1 does
    not fit or there are 2^16 A bands or more (a count is kept in 16
    bits)."""
    offs_a = tuple(offs_a)
    if word not in DENSE_GEOMETRY:
        raise ValueError(f"{word}-byte words: the dense entries take 4 or 8")
    if not offs_a or d2n <= 0 or dcn <= 0:
        raise ValueError(f"{len(offs_a)} A bands, d2n={d2n}, dcn={dcn}")
    if len(offs_a) >= 1 << 16:
        raise ValueError(f"{len(offs_a)} A bands: the kernel's counts are "
                         "16-bit")
    geo = DENSE_GEOMETRY[word]
    rows, cols, threads = geo["rows"], geo["cols"], geo["threads"]
    tr = min(MAX_ROW_BLOCKS, threads // 32,
             _pow2_at_least(-(-dcn // rows)))
    tc_n = min(threads // tr, MAX_COL_BLOCKS)
    L = tc_n * cols
    rb = rows * tr
    grid_y = -(-dcn // rb)
    for kc in (128, 64, 32, 16, 8, 4, 2, 1):
        chunks = dense_chunks(offs_a, kc)
        a_rows = max(ke - kb for kb, ke in chunks)
        span = max(offs_a[ke - 1] - offs_a[kb] for kb, ke in chunks)
        rows_cap = min(d2n, rb + span) + 2 * (rows - 1)
        cols_cap = L + span
        s = -(-max(cols_cap, rows_cap + 3) // 32) * 32
        b_off = a_rows * L
        stage = b_off + rows_cap * s
        if word * stage <= SMEM_BUDGET:
            break
    else:
        raise ValueError(f"the dense entry's window for {d2n} B bands does "
                         "not fit in shared memory")
    cw = min(COPY_WIDTH, _pow2_at_least(cols_cap))
    return dict(tr_log2=tr.bit_length() - 1, tc_n=tc_n, rows=rows,
                cols=cols, L=L, rows_per_block=rb, grid_y=grid_y, kc=kc,
                a_rows=a_rows, span=span, rows_cap=rows_cap,
                cols_cap=cols_cap, s=s, cw_log2=cw.bit_length() - 1,
                b_off=b_off, word=word, stage_words=stage,
                smem_bytes=word * stage, threads=tr * tc_n,
                chunks=len(chunks))


# --------------------------------------------------------------------------
# the pairs entry's launch shape

def pairs_launch(d1n: int, dcn: int, n_pairs: int, n_out: int):
    """The pairs entry's launch shape for d1n A bands, dcn C rows, n_pairs
    band pairs and n_out columns.

    A block owns PAIR_L columns (PAIR_COLS a thread, PAIR_THREADS apart) of
    the C rows blockIdx.y, blockIdx.y + grid_y, ...: grid_x column ranges,
    neighbours in the grid, and grid_y row groups only where the column
    ranges alone give fewer than PAIRS_MIN_BLOCKS blocks.  Shared memory
    holds, from word 0 on, the block's words of every A band (stage_a:
    d1n x PAIR_L floats) and then the row_ptr / trip tables
    (stage_tables), each where it fits in SMEM_BUDGET beside what comes
    before it; what is not staged is read where it lies."""
    if d1n <= 0 or dcn <= 0 or n_pairs <= 0 or n_out <= 0:
        raise ValueError(f"d1n={d1n}, dcn={dcn}, n_pairs={n_pairs}, "
                         f"n_out={n_out}")
    grid_x = -(-n_out // PAIR_L)
    grid_y = min(dcn, max(1, -(-PAIRS_MIN_BLOCKS // grid_x)))
    a_bytes = 4 * d1n * PAIR_L
    t_bytes = 4 * (dcn + 1 + 3 * n_pairs)
    stage_a = a_bytes <= SMEM_BUDGET
    used = a_bytes if stage_a else 0
    stage_tables = used + t_bytes <= SMEM_BUDGET
    return dict(grid_x=grid_x, grid_y=grid_y, L=PAIR_L, cols=PAIR_COLS,
                threads=PAIR_THREADS, stage_a=stage_a,
                stage_tables=stage_tables,
                smem_bytes=used + (t_bytes if stage_tables else 0))


# --------------------------------------------------------------------------
# offset tables

def pair_table(offs_a, offs_b, dc_list):
    """(row_ptr, trip) int32 numpy: a CSR over C rows of the (k1, k2, d1)
    triples of every band pair, ascending k1 within a row."""
    _, idx_map = _plan_maps(offs_a, offs_b)
    trip = np.array([(idx_map[k1][k2], k1, k2, d1)
                     for k1, d1 in enumerate(offs_a)
                     for k2 in range(len(offs_b))], np.int64).reshape(-1, 4)
    trip = trip[np.lexsort((trip[:, 1], trip[:, 0]))]
    row_ptr = np.zeros(len(dc_list) + 1, np.int32)
    row_ptr[1:] = np.cumsum(np.bincount(trip[:, 0], minlength=len(dc_list)))
    return row_ptr, np.ascontiguousarray(trip[:, 1:], np.int32)


def dia_tables(offs_a, offs_b, dc_list, mode, device):
    """The kernel's offset tables as int32 tensors on ``device``: (offs_a,)
    for 'dense', (row_ptr, trip) for 'pairs'.  A plan builds them once."""
    if mode == "dense":
        host = (np.asarray(offs_a, np.int32),)
    elif mode == "pairs":
        host = pair_table(offs_a, offs_b, dc_list)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return tuple(torch.from_numpy(x).to(device) for x in host)


# --------------------------------------------------------------------------
# wrapper

def _check_bands(x, name, device=None, dtype=None):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} must be float32 or float64, got {x.dtype}")
    if dtype is not None and x.dtype != dtype:
        raise TypeError(f"{name} is {x.dtype}, the A bands {dtype}")
    if x.dim() != 2:
        raise ValueError(f"{name} must be 2-D (bands, n), got "
                         f"{tuple(x.shape)}")
    if device is not None and x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dia_multiply(a_bands, b_bands, *, offs_a, offs_b, dc_list, n_out,
                 mode="dense", values_only=False, tables=None):
    """(c_bands, c_counts | None), both (len(dc_list), n_out); c_bands in
    the bands' dtype, c_counts float32.

    a_bands (len(offs_a), n_i) and b_bands (len(offs_b), n_k), both float32
    or both float64 (the float64 entries), row-aligned band stacks;
    offs_a / offs_b ascending offset tuples;
    dc_list the plan's C offsets (``ops.dia._plan_maps``); n_out <= n_i.
    mode='dense' requires ``dense_qualifies``.  ``tables`` are the device
    tables of ``dia_tables`` for these offsets and this mode: CUDA bands
    need them (a plan builds them once), CPU bands do not read them.
    """
    offs_a, offs_b, dc_list = tuple(offs_a), tuple(offs_b), tuple(dc_list)
    _check_bands(a_bands, "a_bands")
    _check_bands(b_bands, "b_bands", a_bands.device, a_bands.dtype)
    if a_bands.shape[0] != len(offs_a) or b_bands.shape[0] != len(offs_b):
        raise ValueError(
            f"band stacks {tuple(a_bands.shape)}, {tuple(b_bands.shape)} do "
            f"not match {len(offs_a)} and {len(offs_b)} offsets")
    if not offs_a or not offs_b:
        raise ValueError("empty offset set")
    n_i, n_k = int(a_bands.shape[1]), int(b_bands.shape[1])
    if not 0 <= n_out <= n_i:
        raise ValueError(f"n_out={n_out} exceeds the A bands' length {n_i}")
    if mode not in ("dense", "pairs"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "dense" and not dense_qualifies(offs_a, offs_b, dc_list):
        raise ValueError("mode='dense' needs a dense B offset range and a "
                         "dense range of offset sums")
    dcn = len(dc_list)
    if not a_bands.is_cuda:
        want_dc, idx_map = _plan_maps(offs_a, offs_b)
        if dc_list != want_dc:
            raise ValueError("dc_list is not the sorted set of offset sums")
        return _dia_multiply_torch(a_bands, b_bands, offs_a=offs_a,
                                   idx_map=idx_map, dc_count=dcn,
                                   n_out=n_out, values_only=values_only)
    if tables is None:
        raise ValueError("CUDA bands need the offset tables of dia_tables()")
    dev = a_bands.device
    wide = a_bands.dtype == torch.float64
    c = torch.empty((dcn, n_out), dtype=a_bands.dtype, device=dev)
    cnt = None if values_only else torch.empty(
        (dcn, n_out), dtype=torch.float32, device=dev)
    if c.numel() == 0:                  # nothing to launch, nothing counted
        return c, cnt
    shape = dense_launch(offs_a, len(offs_b), dcn,
                         a_bands.element_size()) if mode == "dense" else None
    for t in tables:
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("tables must be contiguous int32 tensors on "
                             "the bands' device")
    lib = _library()
    cnt_ptr = None if cnt is None else cnt.data_ptr()
    entry = f"dia_multiply_{mode}" + ("_f64" if wide else "")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if mode == "dense":
            (offs_dev,) = tables
            if offs_dev.numel() != len(offs_a):
                raise ValueError("tables do not match offs_a")
            fn = lib.dia_multiply_dense_f64 if wide \
                else lib.dia_multiply_dense_f32
            err = fn(
                a_bands.data_ptr(), b_bands.data_ptr(), offs_dev.data_ptr(),
                c.data_ptr(), cnt_ptr, len(offs_a), len(offs_b), dcn, n_i,
                n_k, n_out, shape["tr_log2"], shape["tc_n"], shape["kc"],
                shape["s"], shape["cw_log2"], shape["b_off"],
                shape["stage_words"], stream)
        elif wide:
            err = _launch_pairs_f64(lib, a_bands, b_bands, tables, c,
                                    cnt_ptr, offs_a, offs_b, dcn, n_i, n_k,
                                    n_out, stream)
        else:
            row_ptr, trip = tables
            n_pairs = len(offs_a) * len(offs_b)
            if row_ptr.numel() != dcn + 1 or trip.numel() != 3 * n_pairs:
                raise ValueError("tables do not match the offset sets")
            shape = pairs_launch(len(offs_a), dcn, n_pairs, n_out)
            err = lib.dia_multiply_pairs_f32(
                a_bands.data_ptr(), b_bands.data_ptr(), row_ptr.data_ptr(),
                trip.data_ptr(), c.data_ptr(), cnt_ptr, len(offs_a), dcn,
                n_pairs, offs_a[0], offs_a[-1], n_i, n_k, n_out,
                shape["grid_y"],
                int(shape["stage_a"]), int(shape["stage_tables"]),
                shape["smem_bytes"], stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed with error {err}")
    LAUNCHES[entry] += 1
    return c, cnt


def _launch_pairs_f64(lib, a_bands, b_bands, tables, c, cnt_ptr, offs_a,
                      offs_b, dcn, n_i, n_k, n_out, stream):
    """Launch the float64 pairs entry; returns its cudaError_t."""
    row_ptr, trip = tables
    if row_ptr.numel() != dcn + 1 or \
            trip.numel() != 3 * len(offs_a) * len(offs_b):
        raise ValueError("tables do not match the offset sets")
    return lib.dia_multiply_pairs_f64(
        a_bands.data_ptr(), b_bands.data_ptr(), row_ptr.data_ptr(),
        trip.data_ptr(), c.data_ptr(), cnt_ptr, dcn, n_i, n_k, n_out, stream)
