"""MatrixMarket I/O and the command line of the PyTorch port: mirrors of
tests/test_mtx.py and of the CLI tests of tests/test_bench.py (on
device="cpu"), and read parity with the JAX package's reader on the same
files."""

import os

import numpy as np
import pytest

from test_torch_util import one_torch_thread, xla_unoptimized
from pem_spgemm_tpu.io import mtx as j_mtx
from pem_spgemm_tpu_torch.bench import cli
from pem_spgemm_tpu_torch.formats.coo import COOMatrix
from pem_spgemm_tpu_torch.io import mtx as t_mtx
from pem_spgemm_tpu_torch.io.mtx import (read_matrix_market,
                                         save_result_files,
                                         write_matrix_market)
from pem_spgemm_tpu_torch.ops import _build

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__,
                                     xla_unoptimized.__name__)

HEADERS = {
    "real_general": (
        "%%MatrixMarket matrix coordinate real general\n"
        "% comment line\n"
        "4 4 3\n1 1 1.5\n2 3 -2.25e-3\n4 4 7\n"),
    "integer": (
        "%%MatrixMarket matrix coordinate integer general\n"
        "3 3 2\n1 2 4\n3 3 -7\n"),
    "pattern": (
        "%%MatrixMarket matrix coordinate pattern general\n"
        "3 3 2\n1 2\n3 1\n"),
    "complex": (
        "%%MatrixMarket matrix coordinate complex general\n"
        "2 2 2\n1 1 3.5 -1.0\n2 2 0.5 2.0\n"),
    "symmetric": (
        "%%MatrixMarket matrix coordinate real symmetric\n"
        "3 3 3\n1 1 2.0\n2 1 -1.0\n3 3 4.0\n"),
    "skew": (
        "%%MatrixMarket matrix coordinate real skew-symmetric\n"
        "3 3 2\n2 1 5.0\n3 2 -1.5\n"),
}


def _write(tmp_path, name, text):
    path = str(tmp_path / f"{name}.mtx")
    with open(path, "w") as f:
        f.write(text)
    return path


def _sorted(m):
    k = np.lexsort((m.cols, m.rows))
    return m.rows[k], m.cols[k], m.vals[k]


@pytest.mark.parametrize("name", sorted(HEADERS))
def test_native_python_parity(tmp_path, name):
    path = _write(tmp_path, name, HEADERS[name])
    a = read_matrix_market(path, native=True)
    b = read_matrix_market(path, native=False)
    assert a.shape == b.shape
    for x, y in zip(_sorted(a), _sorted(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("name", sorted(HEADERS))
def test_read_equals_the_jax_package(tmp_path, name, native):
    path = _write(tmp_path, name, HEADERS[name])
    t = read_matrix_market(path, native=native)
    # the JAX package's numpy parser: its native build writes beside the
    # sources, where its own tests may be building it in another worker
    j = j_mtx.read_matrix_market(path, native=False)
    assert tuple(t.shape) == tuple(j.shape) and t.nnz == j.nnz
    assert t.vals.dtype == j.vals.dtype and t.rows.dtype == j.rows.dtype
    # same order too: both emit the file's entries, then the mirrored ones
    np.testing.assert_array_equal(t.rows, j.rows)
    np.testing.assert_array_equal(t.cols, j.cols)
    np.testing.assert_array_equal(t.vals, j.vals)


def test_native_libraries_are_built_in_the_ports_own_directory(tmp_path):
    path = _write(tmp_path, "r", HEADERS["real_general"])
    read_matrix_market(path, native=True)
    lib = t_mtx._get_native("mtx_reader", t_mtx._declare_reader)
    if lib is None:
        pytest.skip("no g++ here: the numpy parser served the read")
    built = [n for n in os.listdir(_build.BUILD_DIR)
             if n.startswith("libmtx_reader_") and n.endswith(".so")]
    assert built
    root_csrc = os.path.join(os.path.dirname(_build.PKG_DIR), "csrc")
    assert os.path.samefile(t_mtx._CSRC, root_csrc)
    assert os.path.isfile(os.path.join(root_csrc, "mtx_reader.cpp"))
    assert os.path.dirname(lib._name) == _build.BUILD_DIR


def test_symmetry_expansion(tmp_path):
    m = read_matrix_market(_write(tmp_path, "s", HEADERS["symmetric"]))
    dense = m.to_scipy().toarray()
    assert m.nnz == 4  # one off-diagonal mirrored
    np.testing.assert_array_equal(dense, dense.T)


def test_skew_expansion(tmp_path):
    path = _write(tmp_path, "sk", HEADERS["skew"])
    dense = read_matrix_market(path).to_scipy().toarray()
    np.testing.assert_array_equal(dense, -dense.T)


def test_complex_real_part(tmp_path):
    # the reference keeps only the real part
    m = read_matrix_market(_write(tmp_path, "c", HEADERS["complex"]))
    np.testing.assert_array_equal(np.sort(m.vals), [0.5, 3.5])


def test_truncated_raises(tmp_path):
    path = _write(tmp_path, "t",
                  "%%MatrixMarket matrix coordinate real general\n"
                  "3 3 5\n1 1 1.0\n2 2 2.0\n")
    with pytest.raises(ValueError, match="truncated"):
        read_matrix_market(path, native=True)
    with pytest.raises(ValueError, match="truncated"):
        read_matrix_market(path, native=False)


def test_not_mtx_raises(tmp_path):
    path = _write(tmp_path, "x", "garbage\n")
    with pytest.raises(ValueError):
        read_matrix_market(path, native=False)
    with pytest.raises(ValueError):
        read_matrix_market(path, native=True)


def test_write_read_round_trip(tmp_path):
    rs = np.random.default_rng(0)
    m = COOMatrix(rs.integers(0, 50, 30), rs.integers(0, 70, 30),
                  rs.standard_normal(30), (50, 70)).sum_duplicates()
    path = str(tmp_path / "w.mtx")
    write_matrix_market(path, m)
    got = read_matrix_market(path)
    assert got.shape == m.shape and got.nnz == m.nnz
    np.testing.assert_allclose(got.vals, m.vals)
    # the JAX package reads the port's file to the same triplets
    j = j_mtx.read_matrix_market(path, native=False)
    np.testing.assert_array_equal(j.rows, got.rows)
    np.testing.assert_array_equal(j.vals, got.vals)


def test_save_result_files(tmp_path):
    m = COOMatrix(np.array([0, 1]), np.array([1, 0]),
                  np.array([1.25, -2.5]), (2, 2))
    paths = save_result_files(str(tmp_path), m)
    assert open(paths["NNZ"]).read().strip() == "2"
    assert np.loadtxt(paths["VALS"]).tolist() == [1.25, -2.5]


def test_result_writer_native_matches_python(tmp_path):
    rs = np.random.default_rng(3)
    m = COOMatrix(rs.integers(0, 500, 200).astype(np.int32),
                  rs.integers(0, 500, 200).astype(np.int32),
                  rs.standard_normal(200), (500, 500))
    p1 = save_result_files(str(tmp_path / "n"), m)
    p2 = save_result_files(str(tmp_path / "p"), m, native=False)
    for k in ("NNZ", "ROWS", "COLS"):
        assert open(p1[k]).read().split() == open(p2[k]).read().split()
    v1 = [float(x) for x in open(p1["VALS"]).read().split()]
    v2 = [float(x) for x in open(p2["VALS"]).read().split()]
    np.testing.assert_array_equal(v1, v2)


# --------------------------------------------------------------------------
# the command line (mirrors of tests/test_bench.py's CLI tests)

def test_cli_synthetic(tmp_path, capsys):
    record = cli.main(["banded:n=500", "0", "--repeat", "1", "--warmup", "0",
                       "--csv", str(tmp_path / "r.csv"), "--device", "cpu"])
    assert record.c_nnz > 0
    out = capsys.readouterr().out
    assert "GFlops" in out
    assert len(open(tmp_path / "r.csv").read().strip().split("\n")) == 2


def test_cli_save_result(tmp_path):
    record = cli.main(["banded:n=200", "1", "--repeat", "1", "--warmup", "0",
                       "--no-csv", "--outdir", str(tmp_path), "--device",
                       "cpu"])
    nnz = int(open(tmp_path / "SPGEMM_RESULT_NNZ.txt").read())
    assert nnz == record.c_nnz
    vals = np.loadtxt(tmp_path / "SPGEMM_RESULT_VALS.txt")
    assert len(vals) == nnz


@pytest.mark.parametrize("engine", ["auto", "element", "dia", "macro"])
def test_cli_reads_a_matrix_market_file(tmp_path, engine):
    # a tridiagonal matrix written as a symmetric .mtx: auto takes the DIA
    # engine, element and macro are forced past it, and all agree with scipy
    n = 120
    lines = [f"{i + 1} {i + 1} {1.0 + i % 7}" for i in range(n)]
    lines += [f"{i + 2} {i + 1} {0.5 + i % 3}" for i in range(n - 1)]
    path = _write(tmp_path, "tri",
                  "%%MatrixMarket matrix coordinate real symmetric\n"
                  f"{n} {n} {len(lines)}\n" + "\n".join(lines) + "\n")
    out = tmp_path / engine
    record = cli.main([path, "1", "--repeat", "1", "--warmup", "0",
                       "--no-csv", "--outdir", str(out), "--engine", engine,
                       "--device", "cpu"])
    s = read_matrix_market(path).to_scipy().tocsr()
    want = (s @ s).tocoo()
    want.sum_duplicates()
    order = np.lexsort((want.col, want.row))
    assert record.matrix == "tri" and record.c_nnz == want.nnz
    assert int(open(out / "SPGEMM_RESULT_NNZ.txt").read()) == want.nnz
    np.testing.assert_array_equal(
        np.loadtxt(out / "SPGEMM_RESULT_ROWS.txt", dtype=np.int64),
        want.row[order])
    np.testing.assert_array_equal(
        np.loadtxt(out / "SPGEMM_RESULT_COLS.txt", dtype=np.int64),
        want.col[order])
    np.testing.assert_allclose(np.loadtxt(out / "SPGEMM_RESULT_VALS.txt"),
                               want.data[order], rtol=2e-5, atol=1e-5)


def test_cli_rejects_what_is_not_ported(tmp_path):
    """What still raises: A@A of a rectangular matrix.  The f64 parity
    mode, --dtype bf16 on every engine (auto, which takes the DIA engine
    here, included), --engine fused and --save-converted run (each raised
    until its slice landed)."""
    from pem_spgemm_tpu_torch.io.persist import load_dia, load_tiled
    base = ["banded:n=100", "0", "--no-csv", "--device", "cpu"]
    want = cli.main(base + ["--repeat", "1"]).c_nnz
    # the f64 parity mode runs (float64 band stacks on the DIA engine)
    assert cli.main(base + ["--dtype", "f64", "--repeat", "1"]).c_nnz == want
    for engine in ("fused", "masks"):
        assert cli.main(base + ["--engine", engine, "--dtype", "bf16",
                                "--repeat", "1"]).c_nnz == want
    assert cli.main(base + ["--dtype", "bf16", "--engine", "dia",
                            "--repeat", "1"]).c_nnz == want
    assert cli.main(base + ["--dtype", "bf16", "--repeat", "1"]).c_nnz == \
        want
    path = tmp_path / "a.npz"
    cli.main(base + ["--save-converted", str(path), "--repeat", "1"])
    assert load_dia(str(path), device="cpu").shape == (100, 100)
    cli.main(base + ["--save-converted", str(path), "--repeat", "1",
                     "--engine", "fused"])
    assert load_tiled(str(path), device="cpu").tmasks is not None
    assert cli.main(base + ["--engine", "fused", "--repeat", "1"]).c_nnz == \
        want
    assert cli.main(base + ["--engine", "macro", "--repeat", "1"]).c_nnz == \
        cli.main(base + ["--engine", "dia", "--repeat", "1"]).c_nnz
    with pytest.raises(SystemExit):             # A@A of a rectangular matrix
        cli.main(["uniform_random:n_rows=30,n_cols=20,nnz=50", "0",
                  "--no-csv", "--device", "cpu"])
