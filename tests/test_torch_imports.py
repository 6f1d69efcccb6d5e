"""The port stands alone: importing it (and chip_smoke.py's module graph)
pulls in neither jax, the JAX package nor its root bench.py, and nothing
falls back to the CPU on its own."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


_FORBIDDEN = ("bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith(('jax.', 'jaxlib', 'pem_spgemm_tpu.')) or "
              "m in ('pem_spgemm_tpu', 'bench')); print('BAD', bad); "
              "sys.exit(1 if bad else 0)")


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = ["pem_spgemm_tpu_torch", "pem_spgemm_tpu_torch.interop",
            "pem_spgemm_tpu_torch.bench.harness",
            "pem_spgemm_tpu_torch.bench.cli",
            "pem_spgemm_tpu_torch.bench.probe",
            "pem_spgemm_tpu_torch.bench.k1_split",
            "pem_spgemm_tpu_torch.bench.k2_split",
            "pem_spgemm_tpu_torch.bench.k4_split",
            "pem_spgemm_tpu_torch.bench.suite",
            "pem_spgemm_tpu_torch.bench.tiers_ab",
            "pem_spgemm_tpu_torch.formats.dia",
            "pem_spgemm_tpu_torch.formats.macro",
            "pem_spgemm_tpu_torch.ops.symbolic",
            "pem_spgemm_tpu_torch.ops.cstruct",
            "pem_spgemm_tpu_torch.ops.macro",
            "pem_spgemm_tpu_torch.ops.stencil",
            "pem_spgemm_tpu_torch.ops.macro_kernels",
            "pem_spgemm_tpu_torch.ops.tile16_kernels",
            "pem_spgemm_tpu_torch.ops.numeric",
            "pem_spgemm_tpu_torch.io.mtx",
            "pem_spgemm_tpu_torch.ops._build",
            "pem_spgemm_tpu_torch.ops.dia_kernels",
            "pem_spgemm_tpu_torch.ops.binned",
            "pem_spgemm_tpu_torch.ops.fixed",
            "pem_spgemm_tpu_torch.ops.dia",
            "pem_spgemm_tpu_torch.ops.segment_sort",
            "pem_spgemm_tpu_torch.ops.element",
            "pem_spgemm_tpu_torch.ops.csr",
            "pem_spgemm_tpu_torch.ops.scanops",
            "pem_spgemm_tpu_torch.models.synthetic",
            "pem_spgemm_tpu_torch.utils.csv_report",
            "pem_spgemm_tpu_torch.parallel",
            "pem_spgemm_tpu_torch.parallel.distributed",
            "pem_spgemm_tpu_torch.parallel.launch",
            "pem_spgemm_tpu_torch.parallel.dryrun",
            "pem_spgemm_tpu_torch.parallel.sharded",
            "pem_spgemm_tpu_torch.parallel.sharded_dia",
            "pem_spgemm_tpu_torch.parallel.sharded_element",
            "pem_spgemm_tpu_torch.parallel.sharded_macro"]
    p = _run("import sys; import " + ", ".join(mods) + "; " + _FORBIDDEN)
    assert p.returncode == 0, p.stdout + p.stderr


def test_chip_smoke_module_graph_is_clean():
    p = _run("import sys; import chip_smoke; " + _FORBIDDEN)
    assert p.returncode == 0, p.stdout + p.stderr


def test_sources_name_no_jax_import():
    hits = []
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, names in os.walk(os.path.join(ROOT,
                                                   "pem_spgemm_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                s = line.strip()
                if s.startswith(("import jax", "from jax",
                                 "import pem_spgemm_tpu ",
                                 "from pem_spgemm_tpu ",
                                 "from pem_spgemm_tpu.",
                                 "import pem_spgemm_tpu.",
                                 "import bench ", "import bench,",
                                 "from bench ")) or \
                        s in ("import pem_spgemm_tpu", "import bench"):
                    hits.append(f"{path}:{i}: {s}")
    assert not hits, hits


def test_device_none_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is the GPU here")
    from pem_spgemm_tpu_torch import COOMatrix, SpGEMMConfig, coo_to_tiled
    from pem_spgemm_tpu_torch import interop
    from pem_spgemm_tpu_torch.bench.harness import run_benchmark
    from pem_spgemm_tpu_torch.config import resolve_device
    coo = COOMatrix(np.array([0, 1], np.int32), np.array([1, 0], np.int32),
                    np.array([1.0, 2.0], np.float32), (2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coo_to_tiled(coo)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_benchmark(coo, "m", SpGEMMConfig(), verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.plan_from_numpy({})
    from pem_spgemm_tpu_torch import coo_to_dia, detect_dia
    with pytest.raises(RuntimeError, match="no CUDA device"):
        detect_dia(coo)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coo_to_dia(coo)
    from pem_spgemm_tpu_torch import coo_to_macro
    from pem_spgemm_tpu_torch.models.synthetic import by_name, \
        wandering_device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coo_to_macro(coo)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wandering_device(n=256)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        by_name("wandering:n=256")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_benchmark(coo, "m", SpGEMMConfig(engine="macro"), verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.macro_from_numpy({})
    from pem_spgemm_tpu_torch.parallel import dryrun
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.rank_cases([])
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_kernel_source_and_loader_agree():
    from pem_spgemm_tpu_torch.ops import segment_sort as ss
    assert os.path.isfile(ss.SOURCE)
    src = open(ss.SOURCE).read()
    for symbol in ("segment_sort_dedup_f32", "segment_dedup_f32"):
        assert f"int {symbol}(" in src
    assert "compute_90a" in " ".join(ss.NVCC_FLAGS)
    assert "torch/extension.h" not in src
    assert os.path.relpath(ss.BUILD_DIR, ROOT) == os.path.join(
        "pem_spgemm_tpu_torch", "build")


def test_dia_kernel_source_and_loader_agree():
    import re
    from pem_spgemm_tpu_torch.ops import _build
    from pem_spgemm_tpu_torch.ops import dia_kernels as dk
    assert os.path.isfile(dk.SOURCE)
    src = open(dk.SOURCE).read()
    for symbol in ("dia_multiply_dense_f32", "dia_multiply_pairs_f32",
                   "dia_multiply_dense_f64", "dia_multiply_pairs_f64"):
        assert f"int {symbol}(" in src
    assert "torch/extension.h" not in src
    # the wrapper sizes the dense entry's grid with the source's constant
    assert int(re.search(r"constexpr int ROWS = (\d+);", src).group(1)) \
        == dk.ROWS
    # one build module serves every CUDA source, and each is a file
    assert set(_build.CUDA_SOURCES) == {"segment_sort", "dia_multiply",
                                        "macro_accumulate", "row_copy",
                                        "tile16_accumulate"}
    for stem in _build.CUDA_SOURCES:
        assert os.path.isfile(_build.cuda_source(stem))
        assert _build.library_path(_build.cuda_source(stem)).startswith(
            os.path.join(_build.BUILD_DIR, f"lib{stem}_"))


def test_macro_kernel_source_and_loader_agree():
    import ctypes
    from pem_spgemm_tpu_torch.ops import macro_kernels as mk
    assert os.path.isfile(mk.SOURCE)
    src = open(mk.SOURCE).read()
    entries = ("macro_accumulate_pairs_f32", "macro_class_ragged_f32",
               "macro_class_uniform_f32", "macro_accumulate_pairs_f64")
    for symbol in entries:
        assert f'extern "C" int {symbol}(' in src
    # hand-written products: no library GEMM, no PyTorch headers
    for banned in ("torch/extension.h", "cublas", "cutlass", "wmma"):
        assert banned not in src.lower()
    assert "fmaf(" in src
    # the class entries multiply on the tensor cores with the 3xTF32 split
    assert "wgmma.mma_async" in src and ".tf32.tf32" in src
    assert "cvt.rna.tf32.f32" in src
    assert set(mk.LAUNCHES) == {e[:-4] for e in entries[:3]} | {
        "macro_accumulate_pairs_f64", "macro_accumulate_pairs_acc",
        "macro_accumulate_pairs_f64_acc"}

    # the ctypes declarations match the number of C parameters
    class Lib:
        pass

    lib = Lib()
    for e in entries:
        setattr(lib, e, Lib())
    mk._declare(lib)
    for e in entries:
        params = src.split(f'extern "C" int {e}(')[1].split(")")[0]
        fn = getattr(lib, e)
        assert len(fn.argtypes) == params.count(",") + 1, e
        assert fn.restype is ctypes.c_int


def test_build_is_by_content_and_a_failed_build_raises(tmp_path, monkeypatch):
    from pem_spgemm_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "unit.cpp"
    src.write_text('extern "C" int answer() { return 42; }\n')
    first = _build.library_path(str(src))
    src.write_text('extern "C" int answer() { return 43; }\n')
    assert _build.library_path(str(src)) != first
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("no g++ here")
    so = _build.compile_shared(["g++", *_build.GXX_FLAGS], str(src))
    assert _build.load(so).answer() == 43
    assert _build.compile_shared(["false"], str(src)) == so    # not rebuilt
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="build failed"):
        _build.compile_shared(["g++", *_build.GXX_FLAGS], str(src))
    assert not [n for n in os.listdir(_build.BUILD_DIR) if n.endswith(".tmp")]


def test_probe_kernel_source_and_loader_agree():
    import ctypes
    from pem_spgemm_tpu_torch.bench import probe as pr
    assert os.path.isfile(pr.SOURCE)
    src = open(pr.SOURCE).read()
    assert 'extern "C" int row_copy_i32(' in src
    assert "torch/extension.h" not in src
    assert set(pr.LAUNCHES) == {"row_copy"}

    class Lib:
        pass

    lib = Lib()
    lib.row_copy_i32 = Lib()
    pr._declare(lib)
    params = src.split('extern "C" int row_copy_i32(')[1].split(")")[0]
    assert len(lib.row_copy_i32.argtypes) == params.count(",") + 1
    assert lib.row_copy_i32.restype is ctypes.c_int
