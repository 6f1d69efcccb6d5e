"""The row-copy probe (P1) of the PyTorch port on device="cpu".

The CUDA kernel (csrc/row_copy.cu) cannot run here; a CPU tensor takes the
plain version, which is held against numpy's table[src][argsort(dst)], the
check of the JAX package's scripts/pallas_probe3.py.
"""

import numpy as np
import pytest
import torch

from pem_spgemm_tpu_torch.bench import probe as pr


@pytest.mark.parametrize("w", pr.WIDTHS)
def test_plain_row_copy_equals_the_reference_check(w):
    table, src, dst = pr.probe_inputs(w, n_rows=2_000, table_rows=9_001,
                                      seed=w, device="cpu")
    assert table.shape == (9_001, w) and table.dtype == torch.int32
    assert sorted(dst.tolist()) == list(range(2_000))    # a permutation
    pr.reset_launch_counts()
    got = pr.row_copy(table, src, dst)
    want = table.numpy()[src.numpy()][np.argsort(dst.numpy())]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        pr.row_copy_plain(table, src, dst).numpy(), want)
    assert pr.LAUNCHES == {"row_copy": 0}       # the plain version ran


def test_rows_no_copy_names_are_zero_and_n_out_is_kept():
    table = torch.arange(40, dtype=torch.int32).reshape(10, 4)
    src = torch.tensor([3, 3, 9], dtype=torch.int32)
    dst = torch.tensor([4, 0, 2], dtype=torch.int32)
    got = pr.row_copy(table, src, dst, n_out=6)
    assert got.shape == (6, 4)
    for d, s_ in ((4, 3), (0, 3), (2, 9)):
        assert torch.equal(got[d], table[s_])
    assert not got[[1, 3, 5]].any()


def test_probe_inputs_follow_the_seed():
    kw = dict(n_rows=500, table_rows=1_000, device="cpu")
    a = pr.probe_inputs(128, seed=3, **kw)
    b = pr.probe_inputs(128, seed=3, **kw)
    c = pr.probe_inputs(128, seed=4, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
    assert int(a[1].min()) >= 0 and int(a[1].max()) < 1_000


def test_wrapper_rejects_what_the_kernel_does_not_take():
    table = torch.zeros((8, 4), dtype=torch.int32)
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        pr.row_copy(table.float(), idx, idx)
    with pytest.raises(ValueError, match="multiple of 4"):
        pr.row_copy(torch.zeros((8, 6), dtype=torch.int32), idx, idx)
    with pytest.raises(ValueError, match="int32"):
        pr.row_copy(table, idx.long(), idx)
    with pytest.raises(ValueError, match="length"):
        pr.row_copy(table, idx, idx[:1])


def test_probe_inputs_default_to_the_gpu(monkeypatch):
    # device=None means the card, as for every entry point of the port: it
    # raises where there is none, and the CPU has to be asked for by name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pr.probe_inputs(128, n_rows=10, table_rows=20)
    table, _, _ = pr.probe_inputs(128, n_rows=10, table_rows=20,
                                  device="cpu")
    assert table.device.type == "cpu"
