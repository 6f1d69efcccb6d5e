"""Binned element-level SpGEMM: the production hypersparse engine.

Counterpart of the JAX package's ops/binned.py; plans built here are equal,
array by array, to the JAX plans on the same operands (every sort below is
stable for that reason).

Design.  Products of one C row only ever need sorting WITHIN the row.  So:
bin C rows by product count, lay each row's products in a padded segment,
and sort the short segments in batches.

  1. B conversion chops every B row into w-slot chunks stored in a padded
     chunk table (NC+1, 2w) holding column indices and value bits side by
     side (one gather fetches both); tail slots carry a sentinel column.
  2. The plan walks A's rows: each element (i, k) contributes
     ceil(len_k / w) chunk indices; a C row with m total chunks lands in
     the bucket with width class M >= m, padded with dummy-chunk indices.
  3. The plan then moves everything it can prove duplicate-free out of the
     sort path: whole rows (_split_dup_free), single-element rows of long
     B rows (element windows), the non-colliding chunks of colliding rows
     (_collision_closure), and short B rows (fine tables).  What still
     collides is either kept as chunk-granular sort buckets (pack=False)
     or materialised as pre-sorted packed classes (pack=True, the default).
  4. The multiply expands each stream with one indexed load, and runs the
     collision work through ops/segment_sort.py: packed classes through
     its dedup entry, sort buckets through its sort+dedup entry.
  5. c_nnz = the sum of first-flags (exact), one device-to-host copy.

Rows whose padded segment exceeds the bucket cap go to a residual stream
(same chunk expansion, then one global sort).

Values are f32 (bit-packed through the chunk table).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional

import numpy as np
import torch

from pem_spgemm_tpu_torch.ops import scanops
from pem_spgemm_tpu_torch.ops.segment_sort import (segment_dedup,
                                                   segment_sort_dedup)

SENTINEL = 0x7FFFFFFF
W = 32                      # slots per chunk
MAX_CHUNKS = 4096           # widest bucket (chunks); beyond -> residual
VMEM_SORT_MAX = 4096        # widest segment (slots) routed through the
                            # kernel's sort entry (one thread block holds a
                            # whole segment in shared memory)
# fine routed tables: short B rows get per-length-class tables at narrow
# widths, cutting the chunk-tail padding.  Tables store [cols | vals] as
# f32 (cols < 2^24 are exact), the layout the JAX package uses.
FINE_CLASSES = ((8, 8), (32, 32))   # (w, max B-row len) per class
FSENT = float(1 << 24)      # fine-table sentinel column (f32-exact bound)
ROUTE_K = 128               # slab height (table rows per routing block)
ROUTE_P = 128               # reference slots per routing block
ROUTE_MIN_FILL = 0.35       # refs/(G*P) below this -> flat per-row take
ROUTE_MIN_REFS = 1 << 16    # tiny streams stay on the flat take
WIN = 128                   # element-window width of the consec-singles path
WIN_MIN_M = 4               # chunk classes below this keep the flat take
# chunk-count width classes: ~1.5-granular to bound padding at ~25%
CLASSES = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256,
           384, 512, 768, 1024, 1536, 2048, 3072, 4096]


def _f2i(x):
    return x.to(torch.float32).contiguous().view(torch.int32)


def _i2f(x):
    return x.contiguous().view(torch.float32)


def _i32(x, device):
    return torch.as_tensor(np.asarray(x), dtype=torch.int32, device=device)


def _ceil_log2(x: int) -> int:
    return max(1, int(x - 1).bit_length()) if x > 1 else 0


# --------------------------------------------------------------------------
# B-side: chunk table (a conversion product, cached on the operand)

def _window_take(pad, starts, w):
    """(len(starts), w) windows pad[s : s + w]."""
    idx = starts.long()[:, None] + torch.arange(w, device=pad.device)
    return pad[idx], idx


def _build_chunk_table(b_cols, b_vals, starts, ends, w):
    """(NC+1, 2w) table: [j columns | value bits] per chunk, sentinel-padded."""
    dev = b_cols.device
    pad_c = torch.cat([b_cols, torch.full((w,), SENTINEL, dtype=torch.int32,
                                          device=dev)])
    pad_v = torch.cat([_f2i(b_vals), torch.zeros(w, dtype=torch.int32,
                                                 device=dev)])
    cols_t, within = _window_take(pad_c, starts, w)
    vals_t = pad_v[within]
    valid = within < ends.long()[:, None]
    cols_t = torch.where(valid, cols_t, SENTINEL)
    vals_t = torch.where(valid, vals_t, 0)
    table = torch.cat([cols_t, vals_t], dim=1)
    dummy = torch.cat([
        torch.full((1, w), SENTINEL, dtype=torch.int32, device=dev),
        torch.zeros((1, w), dtype=torch.int32, device=dev)], dim=1)
    return torch.cat([table, dummy], dim=0)


def _build_fine_table(b_cols, b_vals, starts, ends, w):
    """(NT_pad, 2w) f32 fine table: [cols as f32 | vals] per row-chunk.

    One row per short B row (len <= w by class construction).  Tail slots
    and padding rows carry the FSENT column sentinel.  Cols are exact in
    f32 (callers gate on n_cols < 2^24)."""
    dev = b_cols.device
    pad_c = torch.cat([b_cols.to(torch.float32),
                       torch.full((w,), FSENT, dtype=torch.float32,
                                  device=dev)])
    pad_v = torch.cat([b_vals.to(torch.float32),
                       torch.zeros(w, dtype=torch.float32, device=dev)])
    cols_t, within = _window_take(pad_c, starts, w)
    vals_t = pad_v[within]
    valid = within < ends.long()[:, None]
    cols_t = torch.where(valid, cols_t, FSENT)
    vals_t = torch.where(valid, vals_t, 0.0)
    return torch.cat([cols_t, vals_t], dim=1)


def _build_wintab(b_cols, b_vals):
    """2D aligned element-window table: row g = [cols | value bits] of
    elements [g*WIN, (g+1)*WIN), sentinel/zero padded, plus one all-dummy
    trailing row for out-of-range window descriptors."""
    dev = b_cols.device
    nb = b_cols.shape[0]
    g = -(-(nb + 1) // WIN) + 1
    pad = g * WIN - nb
    cols = torch.cat([b_cols, torch.full((pad,), SENTINEL,
                                         dtype=torch.int32, device=dev)])
    bits = torch.cat([_f2i(b_vals), torch.zeros(pad, dtype=torch.int32,
                                                device=dev)])
    return torch.cat([cols.reshape(g, WIN), bits.reshape(g, WIN)], dim=1)


@dataclasses.dataclass(frozen=True)
class FineTable:
    """One fine length class (conversion product)."""

    w: int                  # chunk width (== max row len of the class)
    table: torch.Tensor     # (NT_pad, 2w) f32, NT_pad % ROUTE_K == 0
    n_rows: int             # live table rows


@dataclasses.dataclass(frozen=True)
class ChunkedB:
    """B in chunk-table form (conversion product)."""

    table: torch.Tensor     # (NC+1, 2W) i32
    cptr: np.ndarray        # (n_rows+1,) host: chunk offset per B row
    lens: np.ndarray        # (n_rows,) host: B row lengths
    w: int
    cptr_dev: torch.Tensor = None   # device copies (for device planning)
    lens_dev: torch.Tensor = None
    # fine routed tables: per FINE_CLASSES class, the f32 row-chunk table
    # (None when n_cols >= 2^24, where f32 cols lose exactness)
    fine: Optional[tuple] = None        # tuple[FineTable]
    fcls_dev: torch.Tensor = None   # (n_rows+1,) i32 fine class or -1
    fidx_dev: torch.Tensor = None   # (n_rows+1,) i32 row index in class table
    rowof_dev: torch.Tensor = None  # (NC+1,) i32 owner B row per main chunk
    # element-window products (the consec-singles path): per-chunk element
    # start/end, and a 2D ALIGNED view of the raw element arrays: row g
    # holds elements [g*WIN, (g+1)*WIN) as [cols | value bits]
    starts_dev: torch.Tensor = None  # (NC+1,) i32: element start per chunk
    ends_dev: torch.Tensor = None    # (NC+1,) i32: element row-end per chunk
    wintab: torch.Tensor = None      # (ceil((NB+1)/WIN)+1, 2*WIN) i32
    nb: int = 0                      # element count (true NB)

    @property
    def nc(self) -> int:
        return int(self.table.shape[0]) - 1


def chunk_b(b, w: int | None = None) -> ChunkedB:
    """Chunk a TiledMatrix operand's element CSR (cached per matrix).

    w=None picks the chunk width from B's mean live row length.
    """
    cache = getattr(b, "_chunk_cache", None)
    if cache is not None and (w is None or cache.w == w):
        return cache
    b_rowptr, _r, b_cols, b_vals = b.element_csr()
    dev = b_cols.device
    rowptr = b_rowptr.cpu().numpy().astype(np.int64)
    lens = np.diff(rowptr)
    if w is None:
        live = lens[lens > 0]
        mean_len = float(live.mean()) if len(live) else 1.0
        w = 1 << max(3, min(5, int(np.ceil(np.log2(max(mean_len, 1.0))))))
    nch = -(-lens // w)                      # 0 for empty rows
    cptr = np.concatenate([[0], np.cumsum(nch)]).astype(np.int64)
    nc = int(cptr[-1])
    # chunk c of row k starts at rowptr[k] + (c - cptr[k]) * w
    owner = np.repeat(np.arange(len(lens)), nch)
    within = np.arange(nc) - cptr[:-1][owner]
    starts = (rowptr[:-1][owner] + within * w).astype(np.int32)
    ends = rowptr[1:][owner].astype(np.int32)
    table = _build_chunk_table(b_cols, b_vals, _i32(starts, dev),
                               _i32(ends, dev), w)
    nb = int(b_cols.shape[0])
    starts_dev = _i32(np.concatenate([starts, [nb]]), dev)
    ends_dev = _i32(np.concatenate([ends, [nb]]), dev)
    wintab = _build_wintab(b_cols, b_vals)

    # fine routed tables (dup-free short-row fast path).  Gated on the
    # column space fitting f32 exactly.
    n_rows = len(lens)
    fine = None
    fcls = np.full(n_rows + 1, -1, np.int32)
    fidx = np.zeros(n_rows + 1, np.int32)
    if b.shape[1] < (1 << 24):
        fine = []
        lo = 1
        for ci, (wc, maxlen) in enumerate(FINE_CLASSES):
            sel = (lens >= lo) & (lens <= maxlen)
            lo = maxlen + 1
            rows_c = np.nonzero(sel)[0]
            nt = len(rows_c)
            fcls[rows_c] = ci
            fidx[rows_c] = np.arange(nt, dtype=np.int32)
            nt_pad = max(ROUTE_K, -(-nt // ROUTE_K) * ROUTE_K)
            s_c = np.full(nt_pad, nb, np.int64)
            e_c = np.full(nt_pad, nb, np.int64)
            s_c[:nt] = rowptr[:-1][rows_c]
            e_c[:nt] = rowptr[1:][rows_c]
            fine.append(FineTable(
                w=wc, n_rows=nt,
                table=_build_fine_table(b_cols, b_vals, _i32(s_c, dev),
                                        _i32(e_c, dev), wc)))
        fine = tuple(fine)
    owner_pad = np.concatenate([owner, [n_rows]]).astype(np.int32)

    cache = ChunkedB(table=table, cptr=cptr, lens=lens, w=w,
                     cptr_dev=_i32(cptr, dev), lens_dev=_i32(lens, dev),
                     starts_dev=starts_dev, ends_dev=ends_dev,
                     wintab=wintab, nb=nb,
                     fine=fine, fcls_dev=_i32(fcls, dev),
                     fidx_dev=_i32(fidx, dev),
                     rowof_dev=_i32(owner_pad, dev))
    object.__setattr__(b, "_chunk_cache", cache)
    return cache


# --------------------------------------------------------------------------
# A-side plan: the binning step

def quarter_pow2(n: int) -> int:
    """Smallest x >= n of the form 2^k * (4..7)/4: caps padding at 25%
    while keeping the distinct shapes per class logarithmic."""
    n = max(1, int(n))
    if n <= 4:
        return n
    k = (n - 1).bit_length() - 3
    return -(-n >> k) << k


@dataclasses.dataclass(frozen=True)
class Bucket:
    m: int                  # chunks per segment (width class)
    src: torch.Tensor       # (R, m) i32 chunk indices (NC = dummy)
    avals: torch.Tensor     # (R, m) f32 A value per chunk
    seg_rows: torch.Tensor  # (R,) i32 C row per segment
    n_rows: int             # true segment count (R is bucketed capacity)
    single: bool = False    # True: SORT-FREE, every segment's product
                            # multiset has no duplicate j, so the sort and
                            # the dedup are both skipped
    rounds: int = 0         # ceil_log2(longest duplicate run), measured
                            # from structure at plan time; 0 = unknown
    consec: bool = False    # True: the row's chunks are CONSECUTIVE table
                            # rows (single-A-element rows)


@dataclasses.dataclass(frozen=True)
class BinnedPlan:
    """Everything the multiply needs; structure-only (reusable while the
    operands' sparsity is unchanged)."""

    buckets: tuple          # tuple[Bucket]
    res_src: torch.Tensor   # (RC,) i32 residual chunk indices
    res_avals: torch.Tensor  # (RC,) f32
    res_rows: torch.Tensor  # (RC,) i32 C row per residual chunk
    n_res_chunks: int
    w: int
    n_products: int
    table: torch.Tensor     # ChunkedB.table
    # consec-singles element-window stream: flat (TW,) wintab row / lane
    # lo / lane hi / C row / A-value bits
    win: Optional[tuple] = None
    wintab: Optional[torch.Tensor] = None
    # dissolved dup-free streams: coarse chunk-flat remainder (src, avals,
    # rows) and per-class fine routed streams (FineStream)
    coarse: Optional[tuple] = None
    fine: tuple = ()
    # packed collision segments: sort-path buckets re-materialized as
    # element-exact per-class arrays
    packed: tuple = ()      # tuple[PackedBucket]

    def run(self):
        return binned_multiply(self)


def _plan_classify(a_rowptr, a_cols, lens_dev, classes_dev, w, n_base):
    """Per-row class assignment + the count vector for sizing.

    Returns (cls (n_rows,) i32, ech (nnz,) i32, pref, row_chunks, stats)
    where stats packs [per-class counts (2*n_base+2) | total_chunks |
    res_chunks | n_products] as int64 for a single device-to-host copy.
    The product count may exceed 2^31; it is summed in int64 on the device.
    """
    dev = a_cols.device
    lens_e = lens_dev[a_cols.long()]
    ech = torch.where(lens_e > 0, (lens_e + (w - 1)) // w, 0).to(torch.int32)
    pref = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                      torch.cumsum(ech, 0, dtype=torch.int32)])
    rp = a_rowptr.long()
    row_chunks = pref[rp[1:]] - pref[rp[:-1]]
    row_elems = a_rowptr[1:] - a_rowptr[:-1]
    # number of classes strictly below the row's chunk count
    cls = torch.searchsorted(classes_dev, row_chunks).to(torch.int32)
    resid = cls >= n_base
    single = (row_elems == 1) & ~resid
    cls = torch.where(single, cls + n_base, cls)
    cls = torch.where(resid, 2 * n_base, cls)
    cls = torch.where(row_chunks == 0, 2 * n_base + 1, cls).to(torch.int32)
    counts = torch.bincount(cls, minlength=2 * n_base + 2)
    total_chunks = pref[-1].long()
    res_chunks = torch.where(cls == 2 * n_base, row_chunks, 0).sum()
    n_products = lens_e.sum(dtype=torch.int64)
    stats = torch.cat([counts,
                       torch.stack([total_chunks, res_chunks, n_products])])
    return cls, ech, pref, row_chunks, stats


def _plan_layout(a_rowptr, a_cols, a_vals, cptr_dev, cls, ech, pref,
                 row_chunks, cls_counts, region_base_dev, m_of_cls_dev,
                 row_region_base_dev, nc, chunk_cap, flat_total, rc_cap,
                 rows_flat_total, n_cls):
    """Bucket layout: fills the combined [buckets | residual] src/aval
    buffers and the padded per-class row-id table.

    Writes that the JAX planner drops by aiming them out of range go to
    one spare slot past the end of each buffer, which is sliced off.
    """
    dev = a_cols.device
    n_rows = cls.shape[0]
    nnz = a_cols.shape[0]
    cls_l = cls.long()

    # per-class rank of each row: position in the stable sort by class
    # minus the class start (the same rank as a one-hot column cumsum)
    order = torch.sort(cls_l, stable=True).indices
    cls_start = torch.cumsum(cls_counts, 0) - cls_counts
    seg_within = torch.empty(n_rows, dtype=torch.int32, device=dev)
    seg_within[order] = (torch.arange(n_rows, device=dev)
                         - cls_start[cls_l[order]]).to(torch.int32)

    in_bucket = cls < n_cls - 2                 # last two: residual, dead
    is_res = cls == n_cls - 2
    # residual rows lay out chunk-flat: prefix of row_chunks over residual
    res_prefix = torch.cumsum(torch.where(is_res, row_chunks, 0), 0,
                              dtype=torch.int32)
    spare = flat_total + rc_cap
    base_of_row = torch.where(
        in_bucket,
        region_base_dev[cls_l] + seg_within * m_of_cls_dev[cls_l],
        torch.where(is_res, flat_total + res_prefix - row_chunks, spare))

    # per-element: owning row + destination start
    row_of_el = scanops.segment_ids_from_offsets(a_rowptr, nnz)
    row_of_el = row_of_el.clamp(max=n_rows - 1).long()
    el_dst = (base_of_row[row_of_el] + pref[:-1]
              - pref[a_rowptr[:-1].long()][row_of_el])
    e0 = cptr_dev[a_cols.long()]                # chunk run start in table

    # per-chunk: expand elements
    el_of_ch = scanops.segment_ids_from_offsets(pref, chunk_cap)
    el_of_ch = el_of_ch.clamp(max=nnz - 1).long()
    ch_iota = torch.arange(chunk_cap, dtype=torch.int32, device=dev)
    within = ch_iota - pref[:-1][el_of_ch]
    live_ch = ch_iota < pref[-1]
    ch_idx = e0[el_of_ch] + within
    ch_dst = torch.where(live_ch, el_dst[el_of_ch] + within,
                         spare).clamp(max=spare).long()
    ch_aval = a_vals[el_of_ch]
    ch_row = row_of_el[el_of_ch].to(torch.int32)

    # unset slots point at the all-sentinel table row
    src_flat = torch.full((spare + 1,), nc, dtype=torch.int32, device=dev)
    src_flat[ch_dst] = ch_idx
    av_flat = torch.zeros(spare + 1, dtype=torch.float32, device=dev)
    av_flat[ch_dst] = ch_aval
    # residual per-chunk row ids
    res_rows = torch.full((rc_cap + 1,), SENTINEL, dtype=torch.int32,
                          device=dev)
    res_rows[torch.where(ch_dst >= flat_total, ch_dst - flat_total,
                         rc_cap)] = ch_row
    # padded per-class row-id table
    row_dst = torch.where(
        in_bucket, row_region_base_dev[cls_l] + seg_within, rows_flat_total)
    seg_rows_flat = torch.full((rows_flat_total + 1,), SENTINEL,
                               dtype=torch.int32, device=dev)
    seg_rows_flat[row_dst.long()] = torch.arange(n_rows, dtype=torch.int32,
                                                 device=dev)
    return (src_flat[:spare], av_flat[:spare], res_rows[:rc_cap],
            seg_rows_flat[:rows_flat_total])


def _bucket_keys(table, src, m, w):
    """(R, m*w) j keys of a bucket's segments (columns half of the table)."""
    return table[:, :w][src.long()].reshape(src.shape[0], m * w)


def _bucket_dup_flags(table, src, m, w):
    """Structure-only plan pass: per segment, does ANY j appear twice, and
    what is the bucket's longest duplicate run?

    Returns ((R,) bool dup flags, scalar max run length)."""
    r = src.shape[0]
    keys = torch.sort(_bucket_keys(table, src, m, w), dim=1).values
    dup = (keys[:, 1:] == keys[:, :-1]) & (keys[:, 1:] != SENTINEL)
    first = torch.ones((r, m * w), dtype=torch.bool, device=src.device)
    first[:, 1:] = keys[:, 1:] != keys[:, :-1]
    idx = torch.arange(m * w, dtype=torch.int32, device=src.device)
    idx = idx.expand(r, m * w)
    last_first = torch.cummax(torch.where(first, idx, -1), dim=1).values
    run = torch.where(keys != SENTINEL, idx - last_first + 1, 1)
    return dup.any(dim=1), run.max()


def _pad_rows(x, r_cap, fill):
    pad = r_cap - x.shape[0]
    if pad <= 0:
        return x[:r_cap]
    shape = (pad,) + tuple(x.shape[1:])
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                    device=x.device)])


def _split_dup_free(buckets, table, w, gran):
    """Split each sort-path bucket into (duplicate-free rows -> sort-free
    path, duplicate-having rows -> sort path).

    Duplicate-freedom is a pure function of the operands' structure, so
    the (cached) plan decides it once; the multiply then runs the
    expansion-only path for those rows."""
    multi = [b for b in buckets if not b.single]
    if not multi:
        return buckets
    nc = table.shape[0] - 1
    flags = [_bucket_dup_flags(table, b.src, b.m, w) for b in multi]
    stats = torch.stack(
        [torch.stack([f.sum(), mr.long()]) for f, mr in flags]
    ).tolist()                                    # one device-to-host copy
    out = [b for b in buckets if b.single]
    for b, (f, _), (ndup, max_run) in zip(multi, flags, stats):
        r = b.src.shape[0]
        ndup = int(ndup)
        rounds = _ceil_log2(max(2, int(max_run)))
        nfree = r - ndup
        n_dummy = r - b.n_rows
        if ndup == 0:
            out.append(dataclasses.replace(b, single=True))
            continue
        if nfree - n_dummy <= 0:
            out.append(dataclasses.replace(b, rounds=rounds))
            continue
        # dup-free (False) first; dummies trail the frees
        order = torch.sort(f.to(torch.uint8), stable=True).indices
        src = b.src[order]
        avals = b.avals[order]
        seg = b.seg_rows[order]
        rf, rd = gran(nfree), gran(ndup)
        out.append(Bucket(
            m=b.m, src=_pad_rows(src[:nfree], rf, nc),
            avals=_pad_rows(avals[:nfree], rf, 0),
            seg_rows=_pad_rows(seg[:nfree], rf, SENTINEL),
            n_rows=nfree - n_dummy, single=True))
        out.append(Bucket(
            m=b.m, src=_pad_rows(src[nfree:], rd, nc),
            avals=_pad_rows(avals[nfree:], rd, 0),
            seg_rows=_pad_rows(seg[nfree:], rd, SENTINEL),
            n_rows=ndup, single=False, rounds=rounds))
    return out


# --------------------------------------------------------------------------
# Fine routed streams (plan side).  Dup-free rows need no segment
# structure, so single buckets dissolve into: per-class FINE references
# (one ref per short-B-row ELEMENT, peeled at first-chunk granularity so a
# multi-chunk main-table run collapses to one fine row), and a COARSE
# remainder stream of main-table chunks.

def _peel_classify(src, avals, rows, rowof_dev, cptr_dev, fcls_dev):
    """Sort the dup-free chunk stream by destination class.

    Key: fine class c for the FIRST main chunk of a fine-class element;
    n_fine for coarse; n_fine+1 for dropped non-first fine chunks (their
    element is covered by the class-table row) and dummies.  Returns the
    sorted (key, src, avals, rows) streams + per-key counts."""
    n_fine = len(FINE_CLASSES)
    row = rowof_dev[src.long()].long()
    cls = fcls_dev[row]
    isfirst = src == cptr_dev[row]
    key = torch.where(cls >= 0,
                      torch.where(isfirst, cls, n_fine + 1),
                      n_fine)
    key = torch.where(rows == SENTINEL, n_fine + 1, key)
    key_s, order = torch.sort(key, stable=True)
    counts = torch.bincount(key, minlength=n_fine + 2)
    return key_s, src[order], avals[order], rows[order], counts


def _fine_refs(src, rowof_dev, fidx_dev):
    return fidx_dev[rowof_dev[src.long()].long()]


def _route_stats(refs, avals, rows, k, p):
    """Sort refs by table row; derive each ref's (block, slot) under the
    slab grouping (aligned k-row slabs, <= p refs per block, overfull
    slabs split).  Returns sorted streams + per-ref block/slot + G."""
    dev = refs.device
    refs_s, order = torch.sort(refs, stable=True)
    av_s, row_s = avals[order], rows[order]
    n = refs_s.shape[0]
    slab = refs_s // k
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    change = slab[1:] != slab[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    first = torch.cat([one, change])
    slab_start = torch.cummax(torch.where(first, idx, -1), 0).values
    rank = idx - slab_start
    last = torch.cat([change, one])
    # slab end at every ref: reversed running min of last-position markers
    slab_end = torch.cummin(torch.where(last, idx, n).flip(0),
                            0).values.flip(0)
    cnt = slab_end - slab_start + 1
    nblk = (cnt + (p - 1)) // p
    bl_incl = torch.cumsum(torch.where(first, nblk, 0), 0,
                           dtype=torch.int32)
    g_of_ref = bl_incl - nblk + rank // p
    p_of_ref = rank % p
    g_total = bl_incl[-1]
    return (refs_s, av_s, row_s, slab, g_of_ref, p_of_ref, g_total)


def _route_layout(refs_s, av_s, row_s, slab, g_of_ref, p_of_ref, g, p):
    """Scatter the sorted ref stream into the (G,) block table and (G, P)
    slot arrays (padding: loc 0, rows SENTINEL, avals 0)."""
    dev = refs_s.device
    k = ROUTE_K
    block_ids = torch.zeros(g, dtype=torch.int32, device=dev)
    block_ids[g_of_ref.long()] = slab
    flat = (g_of_ref * p + p_of_ref).long()
    loc = torch.zeros(g * p, dtype=torch.int32, device=dev)
    loc[flat] = refs_s % k
    avals = torch.zeros(g * p, dtype=torch.float32, device=dev)
    avals[flat] = av_s
    rows = torch.full((g * p,), SENTINEL, dtype=torch.int32, device=dev)
    rows[flat] = row_s
    return (block_ids, loc.reshape(g, p), avals.reshape(g, p),
            rows.reshape(g, p))


@dataclasses.dataclass(frozen=True)
class FineStream:
    """One fine class's executable reference stream."""

    mode: str               # "einsum" | "flat"
    w: int
    table: torch.Tensor     # (NT_pad, 2w) f32
    # flat mode
    refs: torch.Tensor = None       # (R,) i32
    # einsum mode (the JAX package's name for the slab-routed layout)
    block_ids: torch.Tensor = None  # (G,) i32 slab ids
    loc: torch.Tensor = None        # (G, P) i32 row-in-slab
    avals: torch.Tensor = None      # flat (R,) / einsum (G, P) f32
    rows: torch.Tensor = None       # flat (R,) / einsum (G, P) i32 C rows


def _build_fine_streams(cb, src_parts, aval_parts, row_parts, gran,
                        coarse_parts=None):
    """Peel the dup-free chunk stream into fine/coarse streams.

    src_parts etc. are lists of flat device tensors (one per dissolved
    single bucket): streams that carry EVERY chunk of each of their
    elements, the precondition for first-chunk fine peeling.
    coarse_parts carries chunk streams WITHOUT that guarantee (closure-
    released chunks), dup-free per chunk but pinned to the coarse table.
    Returns (coarse (src, avals, rows) | None, tuple[FineStream])."""
    n_fine = len(FINE_CLASSES)
    coarse_extra = None
    if coarse_parts is not None and coarse_parts[0]:
        coarse_extra = tuple(torch.cat(p) for p in coarse_parts)
    if not src_parts:
        if coarse_extra is None:
            return None, ()
        cap = gran(int(coarse_extra[0].shape[0]))
        return (_pad_rows(coarse_extra[0], cap, cb.nc),
                _pad_rows(coarse_extra[1], cap, 0),
                _pad_rows(coarse_extra[2], cap, SENTINEL)), ()
    src = torch.cat(src_parts)
    avals = torch.cat(aval_parts)
    rows = torch.cat(row_parts)
    _key_s, src_s, av_s, row_s, counts = _peel_classify(
        src, avals, rows, cb.rowof_dev, cb.cptr_dev, cb.fcls_dev)
    counts_h = counts.tolist()                      # device-to-host (plan)
    fine_streams = []
    off = 0
    for ci in range(n_fine):
        n = int(counts_h[ci])
        if n == 0:
            continue
        ft = cb.fine[ci]
        refs = _fine_refs(src_s[off:off + n], cb.rowof_dev, cb.fidx_dev)
        av_c = av_s[off:off + n]
        row_c = row_s[off:off + n]
        off += n
        stats = _route_stats(refs, av_c, row_c, ROUTE_K, ROUTE_P)
        g = int(stats[-1])                          # device-to-host (plan)
        fill = n / max(1, g * ROUTE_P)
        if n >= ROUTE_MIN_REFS and fill >= ROUTE_MIN_FILL:
            block_ids, loc, av_b, row_b = _route_layout(
                *stats[:-1], g=g, p=ROUTE_P)
            fine_streams.append(FineStream(
                mode="einsum", w=ft.w, table=ft.table,
                block_ids=block_ids, loc=loc, avals=av_b, rows=row_b))
        else:
            cap = gran(n)
            fine_streams.append(FineStream(
                mode="flat", w=ft.w, table=ft.table,
                refs=_pad_rows(refs, cap, ft.table.shape[0] - 1),
                avals=_pad_rows(av_c, cap, 0),
                rows=_pad_rows(row_c, cap, SENTINEL)))
    n_coarse = int(counts_h[n_fine])
    coarse = None
    c_src, c_av, c_row = [], [], []
    if n_coarse:
        c_src.append(src_s[off:off + n_coarse])
        c_av.append(av_s[off:off + n_coarse])
        c_row.append(row_s[off:off + n_coarse])
    if coarse_extra is not None:
        c_src.append(coarse_extra[0])
        c_av.append(coarse_extra[1])
        c_row.append(coarse_extra[2])
    if c_src:
        src_c = torch.cat(c_src) if len(c_src) > 1 else c_src[0]
        av_c = torch.cat(c_av) if len(c_av) > 1 else c_av[0]
        row_c = torch.cat(c_row) if len(c_row) > 1 else c_row[0]
        cap = gran(int(src_c.shape[0]))
        coarse = (_pad_rows(src_c, cap, cb.nc),
                  _pad_rows(av_c, cap, 0),
                  _pad_rows(row_c, cap, SENTINEL))
    return coarse, tuple(fine_streams)


# --------------------------------------------------------------------------
# Collision-closure split: a dup-having row only needs the batched sort
# for the chunks whose products actually collide.  The closure of each
# duplicate (i,j) group is a set of CHUNKS (group members live in distinct
# chunks: a chunk is w consecutive elements of one B row, so within-chunk
# duplicates are impossible); compacting just those chunks into narrow
# sort segments and releasing the rest to the dup-free streams removes
# most of the sorted volume in near-unique regimes.

def _collision_chunk_flags(table, src, m, w):
    """(R, m) 0/1: does chunk j of each segment hold any colliding key?"""
    r = src.shape[0]
    dev = src.device
    ks, order = torch.sort(_bucket_keys(table, src, m, w), dim=1,
                           stable=True)
    dup_r = (ks[:, 1:] == ks[:, :-1]) & (ks[:, 1:] != SENTINEL)
    dup = torch.zeros((r, m * w), dtype=torch.int32, device=dev)
    dup[:, 1:] |= dup_r
    dup[:, :-1] |= dup_r
    # back to slot order (order is a permutation of each row), then the
    # per-chunk maximum
    dup_slot = torch.zeros_like(dup).scatter_(1, order, dup)
    return dup_slot.reshape(r, m, w).amax(dim=2)


def _closure_split_bucket(table, src, avals, seg_rows, classes_dev,
                          m, w, n_classes):
    """Compact colliding chunks left; classify rows by colliding count.

    Returns (cls (R,) class of colliding width, src_c/av_c (R, m)
    colliding-first chunk order, flat streams of released chunks
    (src/aval/row with released=live non-colliding; others dummied),
    per-class row counts + released count)."""
    r = src.shape[0]
    dev = src.device
    nc = table.shape[0] - 1
    collide = _collision_chunk_flags(table, src, m, w)     # (R, m)
    live = src != nc
    ncol = collide.sum(dim=1, dtype=torch.int32)
    # colliding chunks first within each row; the non-colliding tail is
    # DUMMIED (it is released to the flat stream: keeping it in the
    # segment would double-count those products)
    order = torch.sort(1 - collide, dim=1, stable=True).indices
    src_c = torch.gather(src, 1, order)
    av_c = torch.gather(avals, 1, order)
    iota_m = torch.arange(m, dtype=torch.int32, device=dev)
    in_col = iota_m[None, :] < ncol[:, None]
    src_c = torch.where(in_col, src_c, nc)
    av_c = torch.where(in_col, av_c, 0.0)
    # row class by colliding-chunk count (0 -> released whole)
    cls = torch.searchsorted(classes_dev, ncol).to(torch.int32)
    cls = torch.where(ncol == 0, n_classes, cls)           # no-collision
    cls = torch.where(seg_rows == SENTINEL, n_classes + 1, cls)  # dummies
    counts = torch.bincount(cls, minlength=n_classes + 2)
    # released (non-colliding, live) chunks as a flat stream
    rel = (collide == 0) & live & (seg_rows != SENTINEL)[:, None]
    rel_flat = rel.reshape(-1)
    src_f = torch.where(rel_flat, src.reshape(-1), nc)
    av_f = torch.where(rel_flat, avals.reshape(-1), 0.0)
    row_f = torch.where(rel_flat, seg_rows.repeat_interleave(m), SENTINEL)
    # released first, dummies last (so the host can slice a prefix)
    order_f = torch.sort((~rel_flat).to(torch.uint8), stable=True).indices
    nrel = rel_flat.sum()
    stats = torch.cat([counts, nrel[None]])
    return (cls, src_c, av_c, src_f[order_f], av_f[order_f],
            row_f[order_f], stats)


def _collision_closure(buckets, table, w, gran):
    """Split every sort bucket into narrow colliding segments + released
    dup-free chunk streams.  Returns (new buckets, released stream parts
    for the peel)."""
    sort_b = [b for b in buckets if not b.single]
    if not sort_b:
        return buckets, [], [], []
    out = [b for b in buckets if b.single]
    classes = list(CLASSES)
    classes_dev = _i32(classes, table.device)
    n_classes = len(classes)
    nc = table.shape[0] - 1
    rel_src, rel_av, rel_row = [], [], []
    # accumulate per-class rows across source buckets, then merge
    merged = {}
    for b in sort_b:
        (cls, src_c, av_c, src_f, av_f, row_f, stats) = \
            _closure_split_bucket(table, b.src, b.avals, b.seg_rows,
                                  classes_dev, b.m, w, n_classes)
        stats_h = stats.tolist()                    # device-to-host (plan)
        counts_h, nrel_h = stats_h[:-1], int(stats_h[-1])
        if nrel_h:
            rel_src.append(src_f[:nrel_h])
            rel_av.append(av_f[:nrel_h])
            rel_row.append(row_f[:nrel_h])
        # rows sorted by class; payloads ride.  No-collision rows (class
        # n_classes) emit nothing here: ALL their live chunks are already
        # in the released stream via the rel mask.
        order = torch.sort(cls, stable=True).indices
        src_s = src_c[order]
        av_s = av_c[order]
        rows_s = b.seg_rows[order]
        off = 0
        for ci in range(n_classes):
            n = int(counts_h[ci])
            if n == 0:
                continue
            mt = min(classes[ci], b.m)
            merged.setdefault(mt, []).append(
                (src_s[off:off + n, :mt], av_s[off:off + n, :mt],
                 rows_s[off:off + n], b.rounds))
            off += n
    for mt, parts in sorted(merged.items()):
        n_rows = sum(p[0].shape[0] for p in parts)
        cap = gran(n_rows)
        src_m = _pad_rows(torch.cat([p[0] for p in parts]), cap, nc)
        av_m = _pad_rows(torch.cat([p[1] for p in parts]), cap, 0)
        row_m = _pad_rows(torch.cat([p[2] for p in parts]), cap, SENTINEL)
        rounds = max(p[3] for p in parts)
        out.append(Bucket(m=mt, src=src_m, avals=av_m, seg_rows=row_m,
                          n_rows=n_rows, single=False, rounds=rounds))
    return out, rel_src, rel_av, rel_row


# --------------------------------------------------------------------------
# Packed collision segments: the chunk-granular sort buckets still pad
# every colliding chunk to w slots and re-fetch it from the table each
# multiply.  The plan removes both costs by MATERIALIZING each segment's
# valid slots, (j, B-value bits, A-value bits) packed contiguously and
# pre-sorted by j, into per-class arrays; the multiply is then the value
# product + the group reduction over the element-exact volume, with no
# take and no sort.  The numeric work stays per-multiply: the arrays are a
# structure-plus-values LAYOUT, like the converted operand formats.

@dataclasses.dataclass(frozen=True)
class PackedBucket:
    """One width class of plan-materialized colliding segments."""

    l: int                  # slots per segment
    keys: torch.Tensor      # (R, l) i32 j keys, SENTINEL padding
    bbits: torch.Tensor     # (R, l) i32 B value bits
    abits: torch.Tensor     # (R, l) i32 A value bits
    seg_rows: torch.Tensor  # (R,) i32 C row per segment
    n_rows: int
    rounds: int             # ceil_log2(longest duplicate run) bound


def _pack_bucket(table, src, avals, seg_rows, pclasses_dev, m, w, n_cls):
    """Pack each segment's valid slots left; classify rows by count.

    One plan-time stable per-row sort moves valid slots to the front
    (payloads: key, B bits, broadcast A bits); rows are then classified
    by live-slot count against the pack classes.  Returns the packed
    (R, m*w) streams in class order + per-class counts."""
    r = src.shape[0]
    raw = table[src.long()]                           # (R, m, 2w)
    keys = raw[:, :, :w].reshape(r, m * w)
    bb = raw[:, :, w:].reshape(r, m * w)
    del raw
    ab = _f2i(avals)[:, :, None].expand(r, m, w).reshape(r, m * w)
    invalid = keys == SENTINEL
    order = torch.sort(invalid.to(torch.uint8), dim=1, stable=True).indices
    cnt = (~invalid).sum(dim=1, dtype=torch.int32)
    cnt = torch.where(seg_rows == SENTINEL, 0, cnt)
    cls = torch.searchsorted(pclasses_dev, cnt).to(torch.int32)
    cls = torch.where(cnt == 0, n_cls, cls)           # dummies drop
    row_order = torch.sort(cls, stable=True).indices
    counts = torch.bincount(cls, minlength=n_cls + 1)
    order = order[row_order]
    return (torch.gather(keys[row_order], 1, order),
            torch.gather(bb[row_order], 1, order),
            torch.gather(ab[row_order], 1, order),
            seg_rows[row_order], counts)


PACK_CLASSES = [2, 4, 8, 16, 32, 48, 64, 96, 128, 192, 256, 384, 512,
                768, 1024, 1536, 2048, 3072, 4096, 6144, 8192, 12288,
                16384, 24576, 32768, 49152, 65536, 98304, 131072,
                196608, 262144]


def _pack_sort_buckets(sort_b, table, w, gran):
    """Materialize every sort bucket's segments as packed per-class
    arrays; same-width classes merge across source buckets.  Plan-time
    only (one device-to-host copy of class counts per bucket)."""
    if not sort_b:
        return ()
    merged = {}                                       # l -> [parts]
    for b in sort_b:
        mw = b.m * w
        pcls = [c for c in PACK_CLASSES if c < mw] + [mw]
        key_s, bb_s, ab_s, row_s, counts = _pack_bucket(
            table, b.src, b.avals, b.seg_rows, _i32(pcls, table.device),
            b.m, w, len(pcls))
        counts_h = counts.tolist()                    # device-to-host (plan)
        off = 0
        for ci, lc in enumerate(pcls):
            n = int(counts_h[ci])
            if n == 0:
                continue
            merged.setdefault(lc, []).append(
                (key_s[off:off + n, :lc], bb_s[off:off + n, :lc],
                 ab_s[off:off + n, :lc], row_s[off:off + n], b.rounds))
            off += n
    out = []
    for lc, parts in sorted(merged.items()):
        n_rows = sum(p[0].shape[0] for p in parts)
        cap = gran(n_rows)

        def cat(i):
            return (torch.cat([p[i] for p in parts]) if len(parts) > 1
                    else parts[0][i])

        keys = _pad_rows(cat(0), cap, SENTINEL)
        bbits = _pad_rows(cat(1), cap, 0)
        abits = _pad_rows(cat(2), cap, 0)
        rows = _pad_rows(cat(3), cap, SENTINEL)
        # PRE-SORT each segment by j at plan time: the key order is pure
        # STRUCTURE, so it belongs to the cached layout.  The per-multiply
        # numeric work is untouched: value multiply, group reduction and
        # emission still run every multiply.
        keys, order = torch.sort(keys, dim=1, stable=True)
        bbits = torch.gather(bbits, 1, order)
        abits = torch.gather(abits, 1, order)
        rounds = max(p[4] for p in parts)
        out.append(PackedBucket(l=lc, keys=keys.contiguous(),
                                bbits=bbits.contiguous(),
                                abits=abits.contiguous(), seg_rows=rows,
                                n_rows=n_rows, rounds=rounds))
    return tuple(out)


def _dedup_tail(key, vals, count=None):
    """Group totals at first slots over per-row sorted keys, first-flags
    and their count (added into ``count`` where given): the dedup entry of
    ops/segment_sort.py (its kernel for CUDA tensors).  The JAX scan's
    depth and width arguments have no counterpart: the kernel's scan
    covers runs of any length."""
    return segment_dedup(key.contiguous(), vals.contiguous(), count=count)


def packed_multiply(keys, bbits, abits, seg_rows, rounds, count=None):
    """Dedup one packed collision class: value multiply (the per-multiply
    numeric work) + group reduction over the plan's pre-sorted keys, fused
    into one pass of the dedup entry.  Contract matches bucket_multiply
    (keys/vals/first (R, l), count; the count added into ``count`` where
    given)."""
    vals, first, count = segment_dedup(keys, bbits, abits, count=count)
    return keys, vals, first, count


def _weighted_row_len(a_cols, b_rowptr):
    """Product-weighted mean B row length: sum(len_e^2)/sum(len_e) over
    A's elements, the statistic that matters for chunk sizing: on skewed
    inputs most PRODUCTS come from hub B rows hundreds long, which the
    unweighted mean row length (a few elements) says nothing about."""
    lens = (b_rowptr[1:] - b_rowptr[:-1]).to(torch.float64)
    le = lens[a_cols.long()]
    return torch.stack([(le * le).sum(), le.sum()])


def pick_w(a, b, w_max: int = 64) -> int:
    """Chunk width from the product-weighted mean row length (one tiny
    device-to-host copy, cached on the operand).  Power of two in
    [8, w_max]."""
    # keyed by a live weakref to b, not id(b): a dead id can be reused by
    # a NEW matrix and silently inherit a stale w
    cache = getattr(a, "_pick_w_cache", None)
    if cache is not None and cache[0]() is b:
        return cache[1]
    a_cols = a.element_csr()[2]
    b_rowptr = b.element_csr()[0]
    s2, s1 = _weighted_row_len(a_cols, b_rowptr).tolist()
    wm = float(s2) / max(float(s1), 1.0)
    w = 1 << int(np.clip(round(np.log2(max(wm, 1.0))), 3,
                         int(np.log2(w_max))))
    object.__setattr__(a, "_pick_w_cache", (weakref.ref(b), w))
    return w


def build_plan_device(a, b, w: int | None = None,
                      max_chunks: int = MAX_CHUNKS,
                      row_cap_gran=None, pack: bool = True) -> BinnedPlan:
    """Device-side binning: one small device-to-host copy between the
    classify pass and the layout.

    The LAYOUT (bucket tables, residual stream, row-id tables) is a pure
    function of the operands' frozen structure and values, so it is cached
    on ``a`` as a conversion product.  Every call still re-runs the
    classify pass and its copy (the bin-setup analog of the reference), so
    the timed step 1 keeps per-multiply semantics; only the O(products)
    layout is amortized."""
    gran = row_cap_gran or quarter_pow2
    if w is None:
        w = pick_w(a, b)
    cb = chunk_b(b, w)
    w = cb.w
    a_rowptr, _ar, a_cols, a_vals = a.element_csr()
    dev = a_cols.device
    base_classes = [c for c in CLASSES if c <= max_chunks]
    n_base = len(base_classes)
    classes_dev = _i32(base_classes, dev)
    cls, ech, pref, row_chunks, stats = _plan_classify(
        a_rowptr, a_cols, cb.lens_dev, classes_dev, w, n_base)

    # weakref to b, not id(b): dead ids are reusable
    cache_key = (w, max_chunks, row_cap_gran, pack)
    cached = getattr(a, "_binned_plan_cache", None)

    stats_h = np.asarray(stats.tolist(), np.int64)   # the one D2H copy
    if (cached is not None and cached[0] == cache_key
            and cached[1]() is b):
        return cached[2]
    counts = stats_h[:2 * n_base + 2]
    total_chunks = int(stats_h[2 * n_base + 2])
    res_chunks = int(stats_h[2 * n_base + 3])
    n_products = int(stats_h[2 * n_base + 4])
    if n_products == 0:
        plan = BinnedPlan(
            buckets=(),
            res_src=torch.full((1,), cb.nc, dtype=torch.int32, device=dev),
            res_avals=torch.zeros(1, dtype=torch.float32, device=dev),
            res_rows=torch.full((1,), SENTINEL, dtype=torch.int32,
                                device=dev),
            n_res_chunks=0, w=w, n_products=0, table=cb.table)
        object.__setattr__(a, "_binned_plan_cache",
                           (cache_key, weakref.ref(b), plan))
        return plan

    n_cls = 2 * n_base + 2
    classes_all = np.concatenate([base_classes, base_classes, [1, 1]])
    caps = np.array([gran(c) if c else 0 for c in counts], np.int64)
    caps[n_cls - 2:] = 0
    region_sizes = caps * classes_all
    region_base = np.concatenate([[0], np.cumsum(region_sizes)])
    flat_total = int(region_base[-1])
    rc_cap = gran(max(1, res_chunks))
    row_region_base = np.concatenate([[0], np.cumsum(caps)])
    rows_flat_total = int(row_region_base[-1])
    chunk_cap = quarter_pow2(max(1, total_chunks))

    src_flat, av_flat, res_rows, seg_rows_flat = _plan_layout(
        a_rowptr, a_cols, a_vals.to(torch.float32), cb.cptr_dev, cls,
        ech, pref, row_chunks, stats[:n_cls],
        _i32(region_base[:-1], dev), _i32(classes_all, dev),
        _i32(row_region_base[:-1], dev), cb.nc,
        chunk_cap=chunk_cap, flat_total=flat_total, rc_cap=rc_cap,
        rows_flat_total=rows_flat_total, n_cls=n_cls)
    del cls, ech, pref, row_chunks

    buckets = []
    for ci in range(n_cls - 2):
        if counts[ci] == 0:
            continue
        m = int(classes_all[ci])
        r_cap = int(caps[ci])
        lo, hi = int(region_base[ci]), int(region_base[ci + 1])
        rlo = int(row_region_base[ci])
        buckets.append(Bucket(
            m=m, src=src_flat[lo:hi].reshape(r_cap, m),
            avals=av_flat[lo:hi].reshape(r_cap, m),
            seg_rows=seg_rows_flat[rlo:rlo + r_cap],
            n_rows=int(counts[ci]), single=ci >= n_base,
            consec=ci >= n_base))
    buckets = _split_dup_free(buckets, cb.table, w, gran)

    # consec-singles element-window conversion: one-element rows with
    # m >= WIN_MIN_M chunks leave the bucket machinery entirely: their
    # products are ONE contiguous slice of B's element arrays, fetched as
    # ceil(len/WIN) aligned window rows instead of m per-chunk rows
    win_parts = []
    kept = []
    for bk in buckets:
        if bk.single and bk.consec and bk.m >= WIN_MIN_M:
            win_parts.append(_bucket_to_windows(
                bk.src[:, 0], bk.avals[:, 0], bk.seg_rows,
                cb.starts_dev, cb.ends_dev,
                n_wintab=int(cb.wintab.shape[0]),
                nwin=-(-bk.m * w // WIN) + 1))
        else:
            kept.append(bk)
    win = None
    if win_parts:
        win = tuple(torch.cat([p[i] for p in win_parts]) for i in range(5))

    # collision-closure split: sort buckets shrink to their truly
    # colliding chunks; released dup-free chunks join the peel below
    kept, rel_src, rel_av, rel_row = _collision_closure(
        kept, cb.table, w, gran)

    # packed collision segments: materialize the surviving sort buckets'
    # valid slots as element-exact per-class arrays
    packed = ()
    if pack:
        packed = _pack_sort_buckets(
            [bk for bk in kept if not bk.single], cb.table, w, gran)
        kept = [bk for bk in kept if bk.single]

    # dissolve the dup-free (single) buckets + released closure chunks
    # into fine routed streams + a coarse chunk-flat remainder
    coarse = None
    fine_streams = ()
    singles = [bk for bk in kept if bk.single]
    kept = [bk for bk in kept if not bk.single]
    src_parts = [bk.src.reshape(-1) for bk in singles]
    av_parts = [bk.avals.reshape(-1) for bk in singles]
    row_parts = [bk.seg_rows.repeat_interleave(bk.m) for bk in singles]
    max_fine_len = FINE_CLASSES[-1][1]
    if w >= max_fine_len:
        # every fine-class element is a single main chunk, so released
        # closure chunks satisfy the first-chunk peel precondition too
        src_parts += rel_src
        av_parts += rel_av
        row_parts += rel_row
        rel_src = []
        rel_av = []
        rel_row = []
    if src_parts or rel_src:
        # (narrow w only) released closure chunks go coarse-only: their
        # element's chunk run may be split between released and
        # colliding, so the first-chunk fine peel cannot apply to them
        coarse, fine_streams = _build_fine_streams(
            cb, src_parts, av_parts, row_parts, gran,
            coarse_parts=(rel_src, rel_av, rel_row))

    plan = BinnedPlan(
        buckets=tuple(kept),
        res_src=src_flat[flat_total:],
        res_avals=av_flat[flat_total:],
        res_rows=res_rows, n_res_chunks=res_chunks,
        w=w, n_products=n_products, table=cb.table,
        win=win, wintab=cb.wintab,
        coarse=coarse, fine=fine_streams, packed=packed)
    object.__setattr__(a, "_binned_plan_cache",
                       (cache_key, weakref.ref(b), plan))
    return plan


# --------------------------------------------------------------------------
# Execution: one take per stream; sort + dedup where products collide

def _expand_bucket(table, src, avals, m, w):
    """(cols, vals) of shape (R, m, w): one row take from the chunk table
    and the a*b products."""
    raw = table[src.long()]                           # (R, m, 2w)
    cols = raw[:, :, :w]
    vals = _i2f(raw[:, :, w:]) * avals[:, :, None]
    return cols, vals


def bucket_multiply(table, src, avals, m, w, rounds=0, count=None):
    """Expand + sort + dedup one bucket with torch.sort; the group
    reduction is the dedup entry of ops/segment_sort.py.  Serves segments
    wider than VMEM_SORT_MAX, and every sort bucket when the kernel sort
    is switched off.

    Returns (keys (R, m*w) i32 sorted j per segment, vals (R, m*w) f32
    with each (i,j) group's total at its first slot, first (R, m*w) bool,
    count scalar i32, added into ``count`` where given).
    """
    r = src.shape[0]
    cols, vals = _expand_bucket(table, src, avals, m, w)
    key, order = torch.sort(cols.reshape(r, m * w), dim=1, stable=True)
    vals = torch.gather(vals.reshape(r, m * w), 1, order)
    del order
    vals, first, count = _dedup_tail(key, vals, count)
    return key, vals, first, count


def bucket_multiply_vmem(table, src, avals, m, w, rounds=0):
    """bucket_multiply with the sort+dedup stage in one pass of the
    hand-written kernel (ops/segment_sort.segment_sort_dedup), which keeps
    a whole segment in a thread block's shared memory.  The name is the
    JAX package's, where the fast memory is VMEM.  Same contract.

    The segment is m ALREADY-SORTED w-runs (chunks are ascending B-row
    slices), so odd chunks are lane-reversed here to establish the bitonic
    alternating-direction invariant and the kernel skips the intra-run
    stages (presorted_w=w)."""
    r = src.shape[0]
    cols, vals = _expand_bucket(table, src, avals, m, w)
    if m > 1:
        odd = (torch.arange(m, device=src.device) & 1).bool()[None, :, None]
        cols = torch.where(odd, cols.flip(2), cols)
        vals = torch.where(odd, vals.flip(2), vals)
    cols = cols.reshape(r, m * w).contiguous()
    vals = vals.reshape(r, m * w).contiguous()
    n_rounds = rounds or (_ceil_log2(m) + 1 if m > 1 else 1)
    key, v, first = segment_sort_dedup(cols, vals, rounds=n_rounds,
                                       presorted_w=w)
    return key, v, first, first.sum(dtype=torch.int32)


def _bucket_to_windows(src0, avals0, seg_rows, starts_dev, ends_dev,
                       n_wintab, nwin):
    """Plan-time: one consec-single bucket -> flat ALIGNED window
    descriptors (wintab row index, valid lane range [lo, hi), C row,
    A-value bits).

    src0 is each row's FIRST chunk id; the chunk table's element
    start/end arrays recover the row's contiguous element range
    [s, s+len), which spans aligned WIN-blocks s>>7 .. (s+len-1)>>7 (at
    most nwin with the straddle).  Dummy rows map to the all-dummy
    trailing wintab row with an empty lane range.
    """
    s0 = src0.long()
    s = starts_dev[s0]
    ln = ends_dev[s0] - s
    j = torch.arange(nwin, dtype=torch.int32, device=src0.device)[None, :]
    idx = ((s[:, None] >> 7) + j).clamp(max=n_wintab - 1)
    base = idx * WIN
    lo = (s[:, None] - base).clamp(0, WIN)
    hi = (s[:, None] + ln[:, None] - base).clamp(0, WIN)
    r = src0.shape[0]
    wrow = seg_rows[:, None].expand(r, nwin)
    wav = _f2i(avals0)[:, None].expand(r, nwin)
    return (idx.reshape(-1), lo.reshape(-1), hi.reshape(-1),
            wrow.reshape(-1), wav.reshape(-1))


def singles_window_multiply(wintab, widx, wlo, whi, wrow, wav):
    """Execute the consec-singles window stream: ONE aligned row take from
    the 2D element-window table + lane masking; no sort, no dedup.

    Returns (keys (TW, WIN), vals, first, rows (TW,), count)."""
    raw = wintab[widx.long()]                         # (TW, 2*WIN)
    lane = torch.arange(WIN, dtype=torch.int32, device=widx.device)[None, :]
    valid = (lane >= wlo[:, None]) & (lane < whi[:, None])
    keys = torch.where(valid, raw[:, :WIN], SENTINEL)
    vals = _i2f(raw[:, WIN:]) * _i2f(wav)[:, None]
    return keys, vals, valid, wrow, valid.sum(dtype=torch.int32)


def singles_multiply_flat(table, srcs, avals, seg_rows, ms, w):
    """ALL sort-free buckets in one chunk-flat take.

    The sort-free contract is per-ROW (no duplicate j anywhere in the
    row's product multiset), so the (R, m) segment structure carries no
    information: chunks are independent.

    Returns (keys (TOT, w), vals (TOT, w), first, rows (TOT,), count).
    """
    src = torch.cat([s.reshape(-1) for s in srcs])
    av = torch.cat([a.reshape(-1) for a in avals])
    rows = torch.cat([r.repeat_interleave(m) for r, m in zip(seg_rows, ms)])
    return coarse_flat_multiply(table, src, av, rows, w)


def coarse_flat_multiply(table, src, avals, rows, w):
    """Dup-free coarse remainder: one chunk-flat take (per-chunk C rows)."""
    raw = table[src.long()]                           # (R, 2w)
    key = raw[:, :w]
    vals = _i2f(raw[:, w:]) * avals[:, None]
    first = key != SENTINEL
    return key, vals, first, rows, first.sum(dtype=torch.int32)


def fine_flat_multiply(ftab, refs, avals, rows, w):
    """Fine-class flat take: (R,) table-row refs from the f32 fine table.

    Sparse reference streams (fill below ROUTE_MIN_FILL) use this; cols
    convert back to i32 exactly (< 2^24 by the fine-table gate)."""
    raw = ftab[refs.long()]                           # (R, 2w) f32
    colsf = raw[:, :w]
    valid = (colsf < FSENT) & (rows != SENTINEL)[:, None]
    key = torch.where(valid, colsf.to(torch.int32), SENTINEL)
    vals = raw[:, w:] * avals[:, None]
    return key, vals, valid, rows, valid.sum(dtype=torch.int32)


def fine_route_multiply(ftab, block_ids, loc, avals, rows, w):
    """Fine-class slab routing over the plan's "einsum"-mode layout.

    This is where the port departs from the JAX package, which fetches
    aligned ROUTE_K-row slabs and distributes rows to reference slots with
    a one-hot matrix product (a workaround for that chip's gather cost).
    Here the same (block_ids, loc) stream is served by one direct indexed
    load of row ``loc`` of slab ``block_ids``: exact by construction, and
    the plan layout stays comparable between the packages."""
    g, p = loc.shape
    k = ROUTE_K
    nt = ftab.shape[0]
    out = ftab.view(nt // k, k, 2 * w)[block_ids.long()[:, None],
                                       loc.long()]    # (G, P, 2w)
    valid_ref = rows != SENTINEL                      # (G, P)
    colsf = out[..., :w]
    valid = (colsf < FSENT) & valid_ref[:, :, None]
    key = torch.where(valid, colsf.to(torch.int32),
                      SENTINEL).reshape(g * p, w)
    vals = torch.where(valid_ref[:, :, None],
                       out[..., w:] * avals[:, :, None], 0.0)
    return (key, vals.reshape(g * p, w), valid.reshape(g * p, w),
            rows.reshape(g * p), valid.sum(dtype=torch.int32))


def residual_multiply(table, src, avals, rowids, w, count=None):
    """Expand residual chunks and sort globally by (i, j); linear dedup.

    The two-key sort is one stable sort on the composite int64 key
    (row << 32) | col.  The group reduction is the dedup entry of
    ops/segment_sort.py over the whole stream as one row, with each
    (i, j) group's ordinal as its key.

    Returns (rows, cols, vals, first, count) flat arrays (RC*w,); the count
    is added into ``count`` where given.
    """
    raw = table[src.long()]                           # (RC, 2w)
    cols = raw[:, :w].reshape(-1)
    vals = (_i2f(raw[:, w:]) * avals[:, None]).reshape(-1)
    del raw
    rows = rowids.repeat_interleave(w)
    rows = torch.where(cols == SENTINEL, SENTINEL, rows)
    order = torch.sort((rows.long() << 32) | cols.long(),
                       stable=True).indices
    rows, cols, vals = rows[order], cols[order], vals[order]
    del order
    new = torch.ones_like(cols, dtype=torch.bool)
    new[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    gid = torch.cumsum(new, 0, dtype=torch.int32) - 1
    gkey = torch.where(cols != SENTINEL, gid, SENTINEL)
    vals, first, count = segment_dedup(gkey[None, :].contiguous(),
                                       vals[None, :].contiguous(),
                                       count=count)
    return rows, cols, vals[0], first[0], count


@dataclasses.dataclass
class BinnedStream:
    """C in bucketed stream form (the engine's native timed output).
    Group totals sit at first-flagged slots; sentinel-keyed slots are
    padding."""

    bucket_keys: tuple      # per stream: (R, L) i32 j
    bucket_vals: tuple      # per stream: (R, L) f32 group totals at first
    bucket_first: tuple     # per stream: (R, L) bool
    bucket_rows: tuple      # per stream: (R,) i32 C row per segment
    res: tuple              # (rows, cols, vals, first) flat residual
    c_nnz: object           # 0-d device tensor until the caller int()s it

    def to_coo_arrays(self):
        """Untimed assembly -> sorted global COO (host numpy).  The
        first-flagged slots are compacted and sorted on the stream's own
        device, so only C crosses to the host."""
        rows, cols, vals = self.device_coo()
        order = torch.sort((rows.long() << 32) | cols.long()).indices
        return (rows[order].cpu().numpy(), cols[order].cpu().numpy(),
                vals[order].cpu().numpy())

    def device_coo(self):
        """C's entries (rows, cols, vals) compacted on the stream's device,
        in stream order (not sorted)."""
        rs, cs, vs = [], [], []
        for k, v, f, rows in zip(self.bucket_keys, self.bucket_vals,
                                 self.bucket_first, self.bucket_rows):
            rs.append(rows[:, None].expand_as(f)[f])
            cs.append(k[f])
            vs.append(v[f])
        rrows, rcols, rvals, rfirst = self.res
        rs.append(rrows[rfirst])
        cs.append(rcols[rfirst])
        vs.append(rvals[rfirst])
        rows = torch.cat(rs)
        cols = torch.cat(cs)
        vals = torch.cat(vs)
        if len(rows) != int(self.c_nnz):
            raise RuntimeError(f"stream holds {len(rows)} first-flagged "
                               f"slots but c_nnz is {int(self.c_nnz)}")
        return rows, cols, vals


def binned_multiply(plan: BinnedPlan, vmem_sort: bool = False
                    ) -> BinnedStream:
    """Execute the planned binned multiply, stage by stage.

    The JAX package fuses the stages into one jitted program to cut its
    dispatch latency (``_binned_multiply_fused``).  Here the stages run
    eagerly, and the counterpart of that program is a CUDA graph of this
    function: ``ops.fixed.BinnedElementPlan`` captures one multiply of a
    cached plan and replays it.  So nothing in here may synchronise with
    the host, allocate outside PyTorch's allocator, or build a kernel
    library on the way (the eager first run builds them).

    vmem_sort=True routes sort-path buckets of at most VMEM_SORT_MAX slots
    through the hand-written sort+dedup kernel (for CUDA tensors; CPU
    tensors take its plain version).  c_nnz stays a device scalar: the
    caller's int() is the one device-to-host copy.  It is ONE accumulator,
    zeroed once: every dedup-entry launch adds its count into it, and the
    counts of the other streams are summed and added to it once."""
    w = plan.w
    table = plan.table
    keys, vals, firsts, rowids = [], [], [], []
    total = torch.zeros((), dtype=torch.int32, device=table.device)
    others = []         # counts of the streams the dedup entry does not see

    def emit(k, v, f, rows, cnt=None):
        keys.append(k)
        vals.append(v)
        firsts.append(f)
        rowids.append(rows)
        if cnt is not None:
            others.append(cnt)

    if plan.win is not None:
        emit(*singles_window_multiply(plan.wintab, *plan.win))
    if plan.coarse is not None:
        emit(*coarse_flat_multiply(table, *plan.coarse, w))
    for fs in plan.fine:
        if fs.mode == "flat":
            emit(*fine_flat_multiply(fs.table, fs.refs, fs.avals, fs.rows,
                                     fs.w))
        else:
            emit(*fine_route_multiply(fs.table, fs.block_ids, fs.loc,
                                      fs.avals, fs.rows, fs.w))
    for p in plan.packed:
        k, v, f, _ = packed_multiply(p.keys, p.bbits, p.abits, p.seg_rows,
                                     p.rounds, count=total)
        emit(k, v, f, p.seg_rows)
    singles = [b for b in plan.buckets if b.single]
    if singles:
        emit(*singles_multiply_flat(
            table, [b.src for b in singles], [b.avals for b in singles],
            [b.seg_rows for b in singles], [b.m for b in singles], w))
    for b in plan.buckets:
        if b.single:
            continue
        if vmem_sort and b.m * w <= VMEM_SORT_MAX:
            k, v, f, cnt = bucket_multiply_vmem(table, b.src, b.avals, b.m,
                                                w, b.rounds)
            emit(k, v, f, b.seg_rows, cnt)
        else:
            k, v, f, _ = bucket_multiply(table, b.src, b.avals, b.m, w,
                                         b.rounds, count=total)
            emit(k, v, f, b.seg_rows)
    rr, rc_, rv, rf, _ = residual_multiply(
        table, plan.res_src, plan.res_avals, plan.res_rows, w, count=total)
    if others:
        total.add_(torch.stack(others).sum(dtype=torch.int32))
    return BinnedStream(
        bucket_keys=tuple(keys), bucket_vals=tuple(vals),
        bucket_first=tuple(firsts), bucket_rows=tuple(rowids),
        res=(rr, rc_, rv, rf), c_nnz=total)
