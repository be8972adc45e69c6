"""Native parser + CLI + CSV logger end-of-pipe tests."""

import os
import subprocess
import sys

import numpy as np
import pytest

from spmv_scpa_tpu.io import mmio, native
from spmv_scpa_tpu.io.loader import load_csr


MTX = """%%MatrixMarket matrix coordinate real general
% comment line
4 5 6
1 1 1.5
1 3 2.0e1
2 2 -3.25
3 5 4.0
4 1 5.5
4 4 -1e-3
"""


@pytest.fixture()
def mtx_file(tmp_path):
    p = tmp_path / "t.mtx"
    p.write_text(MTX)
    return str(p)


def test_native_matches_python(mtx_file):
    if not native.available():
        pytest.skip("native toolchain unavailable")
    ref = mmio.read(mtx_file)
    got = native.read_mtx(mtx_file)
    np.testing.assert_array_equal(got.row, ref.row)
    np.testing.assert_array_equal(got.col, ref.col)
    np.testing.assert_allclose(got.val, ref.val)
    assert (got.nrows, got.ncols) == (ref.nrows, ref.ncols)


def test_native_pattern(tmp_path):
    if not native.available():
        pytest.skip("native toolchain unavailable")
    p = tmp_path / "p.mtx"
    p.write_text("%%MatrixMarket matrix coordinate pattern symmetric\n"
                 "3 3 2\n2 1\n3 3\n")
    got = native.read_mtx(str(p))
    assert got.val is None
    assert got.row.tolist() == [1, 2]
    assert got.col.tolist() == [0, 2]


def test_native_truncated(tmp_path):
    if not native.available():
        pytest.skip("native toolchain unavailable")
    p = tmp_path / "bad.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real general\n"
                 "2 2 3\n1 1 1.0\n")
    from spmv_scpa_tpu.errors import MatrixFormatError
    with pytest.raises(MatrixFormatError):
        native.read_mtx(str(p))


def test_loader_uses_native_and_matches(mtx_file):
    a = load_csr(mtx_file, use_native=False)
    b = load_csr(mtx_file)          # auto (native if buildable)
    np.testing.assert_allclose(a.to_dense(), b.to_dense())


def test_cli_end_to_end(mtx_file, tmp_path):
    from spmv_scpa_tpu.cli import main
    out = str(tmp_path / "res")
    rc = main(["-m", mtx_file, "-o", out, "-d",
               "-b", "xla-csr-segsum"])
    assert rc == 0
    serial = (tmp_path / "res" / "serial.csv").read_text().splitlines()
    assert serial[0] == ("matrix,format,rows,cols,nnz,num_blocks,"
                         "duration_ms,gflops")
    assert serial[1].startswith("t,CSR,4,5,6,,")
    assert serial[2].startswith("t,HLL,4,5,6,")
    cuda = (tmp_path / "res" / "cuda.csv").read_text().splitlines()
    assert cuda[0].startswith("matrix,format,kernel,warps_per_block")
    assert any(",CSR,0," in ln for ln in cuda[1:])
    # append mode: a second run adds rows, keeps single header
    rc = main(["-m", mtx_file, "-o", out, "-b", "xla-csr-segsum"])
    assert rc == 0
    serial2 = (tmp_path / "res" / "serial.csv").read_text().splitlines()
    assert len(serial2) == 2 * (len(serial) - 1) + 1


def test_cli_synth_and_errors(tmp_path):
    from spmv_scpa_tpu.cli import main
    rc = main(["-m", "synth:banded:m=64,row_nnz=4,bandwidth=16",
               "-o", str(tmp_path / "r"), "-b", "xla-csr-segsum", "-d"])
    assert rc == 0
    assert main([]) == 2                       # missing required args
    assert main(["--list-strategies"]) == 0
    rc = main(["-m", str(tmp_path / "nope.mtx"), "-o", str(tmp_path / "r")])
    assert rc != 0


def test_cli_validation_failure_aborts(tmp_path):
    # a kernel that lies must abort the run in debug mode
    # (reference: main.c:161-168)
    import dataclasses

    from spmv_scpa_tpu.cli import main
    from spmv_scpa_tpu.ops import registry

    spec = registry.get_strategy("xla-csr-segsum")
    orig = spec.prepare

    def lying_prepare(A, **kw):
        prep = orig(A, **kw)
        good_fn, good_raw = prep.fn, prep.raw
        prep.fn = lambda x: good_fn(x) + 1e6
        prep.raw = lambda x, *a: good_raw(x, *a) + 1e6
        return prep

    registry._REGISTRY[spec.name] = dataclasses.replace(
        spec, prepare=lying_prepare)
    try:
        rc = main(["-m", "synth:banded:m=64,row_nnz=4,bandwidth=16",
                   "-o", str(tmp_path / "r"), "-b", "xla-csr-segsum", "-d"])
        assert rc != 0
    finally:
        registry._REGISTRY[spec.name] = spec


def test_cache_roundtrip(tmp_path, mtx_file):
    from spmv_scpa_tpu.io.cache import cache_path, load_csr_cached
    A1 = load_csr_cached(mtx_file, cache_dir=str(tmp_path / "c"))
    assert os.path.exists(cache_path(mtx_file, str(tmp_path / "c")))
    A2 = load_csr_cached(mtx_file, cache_dir=str(tmp_path / "c"))
    np.testing.assert_allclose(A1.to_dense(), A2.to_dense())
    assert A1.name == A2.name


def test_cli_print_result(mtx_file, tmp_path, capsys):
    from spmv_scpa_tpu.cli import main
    rc = main(["-m", mtx_file, "-o", str(tmp_path / "r"),
               "-b", "xla-csr-segsum", "--print-result", "3"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "y[:3] =" in out


def test_native_omp_kernels_match_oracle():
    """Native C++/OpenMP kernels (native/spmv_omp.cpp) vs the fp64
    oracle — the reference's OpenMP family (csr.c:218-339,
    hll.c:178-211) with a thread sweep."""
    import numpy as np
    from spmv_scpa_tpu import testing as synth
    from spmv_scpa_tpu.ops import native_omp
    from spmv_scpa_tpu.ops.oracle import spmv_oracle
    from spmv_scpa_tpu.ops.registry import get_strategy
    from spmv_scpa_tpu.utils.vector import make_x
    if not native_omp.available():
        import pytest
        pytest.skip("no native toolchain")
    A = synth.powerlaw_csr(1500, 1200, seed=21)
    x = make_x(A.n)
    gold = spmv_oracle(A, x)
    for name in ("omp-csr-guided", "omp-csr-nnz", "omp-ell"):
        for nt in (1, 4):
            prep = get_strategy(name).prepare(A, nthreads=nt)
            got = prep.fn(x)
            assert np.linalg.norm(got - gold) < 1e-9, (name, nt)


def test_cli_uses_layout_cache(mtx_file, tmp_path, monkeypatch):
    """Second CLI run on the same file must skip the .mtx parse
    entirely (VERDICT r2 missing 4): the .npz cache is default-on."""
    from spmv_scpa_tpu import cli
    from spmv_scpa_tpu.io import cache, loader

    calls = {"n": 0}
    real = loader.load_csr

    def counting(path, **kw):
        calls["n"] += 1
        return real(path, **kw)

    monkeypatch.setattr(loader, "load_csr", counting)
    args = ["-m", mtx_file, "-o", str(tmp_path / "r"),
            "-b", "xla-csr-segsum"]
    assert cli.main(args) == 0
    assert calls["n"] == 1
    assert os.path.exists(cache.cache_path(mtx_file))
    assert cli.main(args) == 0
    assert calls["n"] == 1          # cache hit: no re-parse
    # --no-cache forces the parse
    assert cli.main(args + ["--no-cache"]) == 0
    assert calls["n"] == 2


def test_mmio_chunked_parse_matches(monkeypatch):
    """The pure-Python parser processes the payload in bounded byte
    windows (VERDICT r2 weak 3) — force tiny windows and check the
    result is identical to a one-shot parse."""
    rng = np.random.default_rng(7)
    nnz = 5000
    rows = rng.integers(1, 1000, nnz)
    cols = rng.integers(1, 1000, nnz)
    vals = rng.standard_normal(nnz)
    body = "".join(f"{r} {c} {v:.17g}\n"
                   for r, c, v in zip(rows, cols, vals))
    text = (f"%%MatrixMarket matrix coordinate real general\n"
            f"1000 1000 {nnz}\n" + body).encode()
    ref = mmio.read(text)
    monkeypatch.setattr(mmio, "_PARSE_CHUNK_BYTES", 1 << 10)
    got = mmio.read(text)
    np.testing.assert_array_equal(ref.row, got.row)
    np.testing.assert_array_equal(ref.col, got.col)
    np.testing.assert_array_equal(ref.val, got.val)
    # truncation/trailing detection still works across windows
    from spmv_scpa_tpu.errors import MatrixFormatError
    with pytest.raises(MatrixFormatError, match="truncated"):
        mmio.read((f"%%MatrixMarket matrix coordinate real general\n"
                   f"1000 1000 {nnz + 1}\n" + body).encode())
    with pytest.raises(MatrixFormatError, match="trailing"):
        mmio.read((f"%%MatrixMarket matrix coordinate real general\n"
                   f"1000 1000 {nnz - 1}\n" + body).encode())


def test_native_omp_without_openmp_refuses_threads(monkeypatch):
    """A library built without OpenMP runs one thread: every builder
    refuses a thread count above 1 instead of mislabelling its rows,
    and still computes at one thread."""
    from spmv_scpa_tpu import testing as synth
    from spmv_scpa_tpu.ops import native_omp
    from spmv_scpa_tpu.ops.oracle import spmv_oracle
    from spmv_scpa_tpu.ops.registry import get_strategy
    from spmv_scpa_tpu.utils.vector import make_x
    if not native_omp.available():
        pytest.skip("no native toolchain")
    monkeypatch.setattr(native_omp, "openmp", lambda: False)
    A = synth.banded_csr(500, row_nnz=7, bandwidth=30, seed=4)
    x = make_x(A.n)
    for name in ("omp-csr-guided", "omp-csr-nnz", "omp-ell"):
        with pytest.raises(ValueError, match="without OpenMP"):
            get_strategy(name).prepare(A, nthreads=4)
        got = get_strategy(name).prepare(A, nthreads=1).fn(x)
        assert np.linalg.norm(got - spmv_oracle(A, x)) < 1e-9, name


def test_host_parallel_sweep_records_refusals_without_openmp(
        monkeypatch, tmp_path):
    """The runner's thread sweep on a single-threaded build: rows at
    one thread, refusals (not failures, not rows) above it."""
    from spmv_scpa_tpu import testing as synth
    from spmv_scpa_tpu.bench.runner import RunConfig, run_benchmarks
    from spmv_scpa_tpu.ops import native_omp
    if not native_omp.available():
        pytest.skip("no native toolchain")
    monkeypatch.setattr(native_omp, "openmp", lambda: False)
    cfg = RunConfig(out_dir=str(tmp_path), debug=True, host_parallel=True,
                    omp_threads=(1, 4), strategies=["xla-csr-segsum"])
    rows = run_benchmarks(synth.banded_csr(300, row_nnz=5, seed=2), cfg)
    omp = sorted(r.strategy for r in rows if r.strategy.startswith("omp"))
    assert omp == ["omp_csr_guided@1", "omp_csr_nnz@1", "omp_ell@1"]
    assert sorted((n, c) for n, c, _ in cfg.skipped) == [
        ("omp_csr_guided", "threads=4"), ("omp_csr_nnz", "threads=4"),
        ("omp_ell", "threads=4")]
    assert not cfg.failed
    with open(tmp_path / "omp.csv") as f:
        assert len(f.read().splitlines()) == 4     # header + 3 rows
