"""Synthetic sparse-matrix generators: the benchmark corpus.

Deterministic numpy families that span the structural regimes SpGEMM cares
about, identical (same triplets from the same seed) to the JAX package's:

  * banded        : diagonal stencils (dense tiles, regular tile rows)
  * power_law     : scale-free row/col degree distribution (webbase-1M /
                    scircuit-like; hot rows, skewed tile fill)
  * rmat          : recursive Kronecker graph (graph-analytics regime)
  * uniform_random: worst case for tiling (near-1 nnz per tile)

All generators return canonical COOMatrix (sorted, duplicates summed), apart
from banded_device, which generates the banded family on the device in
band-major order.  The device-side generator of the wandering family arrives
with its engine.
"""

from __future__ import annotations

import numpy as np

from pem_spgemm_tpu_torch.formats.coo import COOMatrix


def _canonical(rows, cols, vals, shape) -> COOMatrix:
    return COOMatrix(rows, cols, vals, shape).sum_duplicates()


def banded(n: int, bands=(0, 1, -1, 16, -16, 200, -200), value: float = 0.0,
           seed: int = 0) -> COOMatrix:
    """Diagonal-stencil matrix; value=0 draws random values."""
    rs = np.random.default_rng(seed)
    bs = np.array(sorted(set(int(b) for b in bands)), np.int64)
    # Build row-major directly (rows x bands grid, masked at the borders):
    # distinct bands cannot collide, so the result is canonical without the
    # O(nnz log nnz) host lexsort (which dominated generation at 10^8 nnz).
    cols_mat = np.arange(n, dtype=np.int64)[:, None] + bs[None, :]
    valid = (cols_mat >= 0) & (cols_mat < n)
    rows = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None],
                           cols_mat.shape)[valid]
    cols = cols_mat[valid].astype(np.int32)
    vals = (np.full(len(rows), value) if value
            else rs.standard_normal(len(rows)))
    return COOMatrix(rows, cols, vals, (n, n))


def power_law(n: int, nnz: int, alpha: float = 2.1, seed: int = 0,
              locality: float = 0.7, hub_correlation: float = 1.0) -> COOMatrix:
    """Scale-free row-degree matrix with tunable column locality
    (webbase-1M-like: hot rows, mostly-local links).

    Every row gets a Pareto-distributed degree scaled so the total lands
    near `nnz`; a `locality` fraction of each row's columns are drawn from
    a +-256 window around the row index, the rest from a Zipf-popular
    global column set.  Duplicates are summed, costing a few percent of
    nnz at most (unlike naive iid zipf sampling, which collapses).

    `hub_correlation` controls whether popular columns point AT high-degree
    rows (webs: hubs link to hubs).  This drives the A@A intermediate-product
    count flop = sum_j colcnt(j)*rowdeg(j): at 1.0 the Zipf column ranks map
    onto rows in descending-degree order, reproducing webbase-1M-like
    compression (products/nnz ~ 20); at 0.0 the mapping is a random
    permutation and the product stays near-diagonal-sparse (products/nnz ~ 2).
    """
    rs = np.random.default_rng(seed)
    raw = (1.0 - rs.random(n)) ** (-1.0 / (alpha - 1.0))   # Pareto >= 1
    raw = np.minimum(raw, n / 8)                           # cap hub rows
    deg_f = raw * (nnz / raw.sum())
    deg = deg_f.astype(np.int64)
    deg += rs.random(n) < (deg_f - deg)                    # stochastic round
    total = int(deg.sum())
    rows = np.repeat(np.arange(n, dtype=np.int32), deg)
    local = rs.random(total) < locality
    off = rs.integers(-256, 257, total)
    near = np.clip(rows.astype(np.int64) + off, 0, n - 1).astype(np.int32)
    u2 = rs.random(total)
    ranks2 = np.minimum((u2 ** (-1.0 / (alpha - 1.0)) - 1.0).astype(np.int64),
                        n - 1)
    # Zipf rank -> column id: rank 0 = most popular.  Correlated mapping
    # sends low ranks to the highest-degree rows.
    by_degree = np.argsort(-deg, kind="stable").astype(np.int32)
    perm = rs.permutation(n).astype(np.int32)
    corr = rs.random(total) < hub_correlation
    far = np.where(corr, by_degree[ranks2], perm[ranks2])
    cols = np.where(local, near, far)
    vals = rs.standard_normal(total)
    return _canonical(rows, cols, vals, (n, n))


def rmat(scale: int, edge_factor: int = 8, seed: int = 0,
         probs=(0.57, 0.19, 0.19, 0.05)) -> COOMatrix:
    """R-MAT / Kronecker graph: n = 2**scale, ~edge_factor*n edges."""
    rs = np.random.default_rng(seed)
    n = 1 << scale
    m = edge_factor * n
    a, b, c, _d = probs
    rows = np.zeros(m, np.int64)
    cols = np.zeros(m, np.int64)
    for bit in range(scale):
        u = rs.random(m)
        r_bit = u >= a + b                     # quadrants c+d set the row bit
        c_bit = ((u >= a) & (u < a + b)) | (u >= a + b + c)  # b or d
        rows |= r_bit.astype(np.int64) << bit
        cols |= c_bit.astype(np.int64) << bit
    vals = rs.standard_normal(m)
    return _canonical(rows.astype(np.int32), cols.astype(np.int32), vals,
                      (n, n))


def uniform_random(n_rows: int, n_cols: int, nnz: int,
                   seed: int = 0) -> COOMatrix:
    rs = np.random.default_rng(seed)
    return _canonical(rs.integers(0, n_rows, nnz).astype(np.int32),
                      rs.integers(0, n_cols, nnz).astype(np.int32),
                      rs.standard_normal(nnz), (n_rows, n_cols))


def banded_device(n: int, bands=(0, 1, -1, 16, -16), seed: int = 0,
                  device=None) -> COOMatrix:
    """banded(), generated directly on the device (``None``: the GPU).

    Counterpart of the JAX package's banded_device: identical structure to
    banded() and to the JAX function (band-major order: ascending offset,
    then row); the values are float32 standard normals from a
    ``torch.Generator`` on the device, so they differ from JAX's PRNG and
    between devices.  A draw that is exactly 0.0 (float32 normals do hit
    it at 10^7 draws) is replaced by 1.0: an explicit zero would drop its
    coordinate from the structure, and the DIA census refuses such inputs.
    For 10^8-nnz inputs this replaces a multi-GB host-to-device copy with
    on-device index arithmetic.
    """
    import torch
    from pem_spgemm_tpu_torch.config import resolve_device
    dev = resolve_device(device)
    bs = torch.tensor(sorted(set(int(b) for b in bands)), dtype=torch.int32,
                      device=dev)
    r = torch.arange(n, dtype=torch.int32, device=dev)
    c = bs[:, None] + r[None, :]                       # (nb, n) band-major
    gen = torch.Generator(device=dev).manual_seed(seed)
    vals2 = torch.randn((len(bs), n), generator=gen, device=dev,
                        dtype=torch.float32)
    vals2[vals2 == 0] = 1.0
    valid = (c >= 0) & (c < n)                         # drop the borders
    rows = r[None, :].expand(len(bs), n)[valid]
    return COOMatrix(rows, c[valid], vals2[valid], (n, n))


def wandering_device(n: int, width: int = 64, block: int = 128,
                     step_max: int = 2, seed: int = 0,
                     device=None) -> COOMatrix:
    """Irregular-macro regime: a dense band whose center WANDERS, generated
    on the device (``None``: the GPU).

    Each 128-row block g carries a ``width``-wide dense band centered at
    column ``i + 128*m_g``, where m_g is a reflected random walk (steps in
    [-step_max, step_max]).  Locally this is banded-like (dense-ish 128x128
    macro tiles), but the diagonal census is ~width * (#distinct walk
    values), so the DIA engine refuses it, and the macro pair stream has no
    periodic signature, so the periodic stencil planner does not cover it.

    Counterpart of the JAX package's wandering_device: the walk is drawn
    from ``np.random.default_rng(seed)`` exactly as there, so the structure
    (and the k-major element order) is identical for the same arguments;
    the values are float32 standard normals from a ``torch.Generator`` on
    the device, exact zeros replaced by 1.0 as in banded_device.  Offsets
    are multiples of ``block`` and the walk is reflected into per-block
    bounds, so every element is in range: nnz == n * width exactly.
    """
    import torch
    from pem_spgemm_tpu_torch.config import resolve_device
    dev = resolve_device(device)
    if n % block:
        raise ValueError(f"n={n} must be a multiple of block={block}")
    nb = n // block
    w2 = width // 2
    rs = np.random.default_rng(seed)
    steps = rs.integers(-step_max, step_max + 1, nb)
    m = np.empty(nb, np.int64)
    cur = 1                                   # m_0 >= 1 keeps col-32 >= 0
    for g in range(nb):
        cur = int(np.clip(cur + steps[g], 1 - g, nb - g - 2))
        m[g] = cur
    m_dev = torch.from_numpy(m.astype(np.int32)).to(dev)
    r = torch.arange(n, dtype=torch.int32, device=dev)
    center = r + block * m_dev[(r // block).long()]
    ks = torch.arange(-w2, width - w2, dtype=torch.int32, device=dev)
    cols2 = ks[:, None] + center[None, :]              # (width, n) k-major
    rows2 = r[None, :].expand(width, n)
    gen = torch.Generator(device=dev).manual_seed(seed)
    vals2 = torch.randn((width, n), generator=gen, device=dev,
                        dtype=torch.float32)
    vals2[vals2 == 0] = 1.0
    return COOMatrix(rows2.reshape(-1), cols2.reshape(-1),
                     vals2.reshape(-1), (n, n))


def by_name(spec: str, device=None) -> COOMatrix:
    """Parse 'family:k=v,k=v' benchmark specs, e.g. 'banded:n=200000'.
    ``device`` goes to the families that generate on the device."""
    name, _, argstr = spec.partition(":")
    kwargs = {}
    if argstr:
        for part in argstr.split(","):
            k, _, v = part.partition("=")
            kwargs[k] = float(v) if "." in v else int(v)
    fams = {"banded": banded, "power_law": power_law, "rmat": rmat,
            "uniform_random": uniform_random,
            "wandering": wandering_device}
    if name not in fams:
        raise ValueError(f"unknown synthetic family {name!r}; "
                         f"one of {sorted(fams)}")
    if name == "wandering":
        kwargs["device"] = device
    return fams[name](**kwargs)
