"""The port's suite driver (bench/suite.py) against the JAX package's root
bench.py: the same table row for row, the same summary line on the same
inputs, and the parent's child handling (one process a matrix, the
per-matrix cap, retries, a wrong structure never retried) driven end to end
on tiny matrices with ``--device cpu``.  The root bench.py is imported here
for its table and its Collector only; the port does not import it."""

import json
import os
import re

import numpy as np
import pytest

import bench
from pem_spgemm_tpu_torch.bench import suite
from pem_spgemm_tpu_torch.models.synthetic import banded_device, power_law

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_BANDED = ("tiny-banded", "banded_device",
               dict(n=2000, seed=1, bands=(-2, -1, 0, 1, 2)), "auto", 4.0)
TINY_POWERLAW = ("tiny-powerlaw", "power_law",
                 dict(n=2000, nnz=8000, seed=3, hub_correlation=0.1),
                 "element", 1.2)
# the keys of bench.py's summary line with every row measured
KEYS = {"metric", "value", "unit", "vs_baseline", "steady_gflops_geomean",
        "steady_vs_baseline", "pipelined_gflops_geomean",
        "pipelined_vs_baseline", "n_matrices"}


def _structural_nnz(coo):
    s = abs(coo.to_scipy().tocsr())
    return int((s @ s).nnz)


def _table(tmp_path, rows):
    path = tmp_path / "table.json"
    path.write_text(json.dumps(rows))
    return str(path)


def _run(tmp_path, capfd, rows, *extra):
    """main() on ``rows`` with --device cpu: (exit code, the stdout lines,
    the stderr text, the CSV lines)."""
    csv = tmp_path / "bench.csv"
    rc = suite.main(["--device", "cpu", "--table", _table(tmp_path, rows),
                     "--csv", str(csv), *extra])
    out, err = capfd.readouterr()
    lines = csv.read_text().splitlines() if csv.exists() else []
    return rc, out.splitlines(), err, lines


def test_table_is_bench_py_row_for_row():
    assert [row[:5] for row in suite.SUITE] == bench.SUITE
    # the C_nnz on record is what the JAX package's last suite run printed,
    # where its log tail still holds the row
    with open(os.path.join(ROOT, "BENCH_r05.json")) as f:
        tail = json.load(f)["tail"]
    printed = {m.group(1): int(m.group(2)) for m in
               re.finditer(r"\[([\w-]+)\] C_nnz=(\d+)", tail)}
    assert printed
    for name, *_rest, c_nnz in suite.SUITE:
        assert printed.get(name, c_nnz) == c_nnz, name


@pytest.mark.parametrize("n_done", [8, 3, 0], ids=["full", "partial",
                                                   "empty"])
def test_summary_is_bench_py_collectors(n_done, capsys):
    g = np.random.default_rng(n_done)
    rows = [(float(a), float(b), float(c), r[4]) for (a, b, c), r in
            zip(g.uniform(0.1, 300.0, (n_done, 3)), bench.SUITE)]
    lines = []
    for cls in (bench.Collector, suite.Collector):
        col = cls(len(bench.SUITE))
        for row in rows:
            col.add(*row)
        col.emit()
        col.emit()                        # a second emit prints nothing
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1] and lines[0].count("\n") == 1
    assert ("partial" in json.loads(lines[0])) == (0 < n_done < 8)


def test_two_matrices_in_children(tmp_path, capfd):
    rows = [TINY_BANDED + (_structural_nnz(banded_device(
                **TINY_BANDED[2], device="cpu")),),
            TINY_POWERLAW + (_structural_nnz(power_law(**TINY_POWERLAW[2])),)]
    rc, out, err, csv = _run(tmp_path, capfd, rows)
    assert rc == 0 and len(out) == 1, (out, err)
    got = json.loads(out[0])
    assert set(got) == KEYS
    assert got["n_matrices"] == 2 and got["value"] > 0
    assert "device: cpu" in err and "engine=dia" in err
    assert len(csv) == 3
    assert [int(line.split(",")[2]) for line in csv[1:]] == \
        [rows[0][5], rows[1][5]]


def test_a_wrong_structure_is_not_retried(tmp_path, capfd):
    good = TINY_BANDED + (_structural_nnz(banded_device(
        **TINY_BANDED[2], device="cpu")),)
    wrong = ("wrong",) + TINY_POWERLAW[1:] + (1,)
    rc, out, err, csv = _run(tmp_path, capfd, [good, wrong])
    assert rc == 1 and len(out) == 1
    got = json.loads(out[0])
    assert got["n_matrices"] == 1 and got["partial"] is True
    assert err.count("[wrong] device:") == 1          # one attempt
    assert "[wrong] WRONG STRUCTURE" in err and "not retried" in err
    assert "retry" not in err
    assert len(csv) == 2                               # no row for it


def test_a_child_past_its_cap_is_killed(tmp_path, capfd, monkeypatch):
    """No child can finish under a one-second cap (its torch import alone
    takes longer): each attempt, the first and two retries, is killed, and
    the line is bench.py's summary of nothing measured."""
    monkeypatch.setenv("PEM_BENCH_MATRIX_CAP_S", "1")
    rc, out, err, csv = _run(tmp_path, capfd, [suite.SUITE[0]])
    bench.Collector(1).emit()
    assert rc == 1 and capfd.readouterr().out.splitlines() == out
    assert err.count("[powerlaw-1M] TIMED OUT after 1s (killed") == 3
    assert "retry 1" in err and "retry 2" in err and not csv


def test_children_default_to_the_gpu():
    """Without --device a child runs on the GPU and raises without one; the
    parent builds the kernels first and raises without nvcc."""
    import shutil

    import torch
    if torch.cuda.is_available() or shutil.which("nvcc"):
        pytest.skip("a CUDA device or nvcc is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        suite.run_one(suite.SUITE[1])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        suite.main(["--first", "1"])
