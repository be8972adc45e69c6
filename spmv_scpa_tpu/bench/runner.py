"""Benchmark orchestration — the ``main.c`` analog.

Mirrors the reference's fixed benchmark order (main.c:361-379):
serial CSR (captured as golden in debug mode, main.c:140-146) →
serial HLL → host-parallel strategies (the OpenMP analog) → device
strategies. Each result is validated against the golden result when
``debug`` is set (utils.c:39-60; failures abort, main.c:161-168) and
appended to the CSV logs (logger.c schemas).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import numpy as np

from spmv_scpa_tpu.bench.logger import CsvLogger
from spmv_scpa_tpu.bench.timing import (BenchResult, time_device_fn,
                                        time_host_fn, time_prepared)
from spmv_scpa_tpu.errors import ValidationError
from spmv_scpa_tpu.formats.csr import CSR
from spmv_scpa_tpu.ops.registry import get_strategy, list_strategies
from spmv_scpa_tpu.utils.validation import validate_result
from spmv_scpa_tpu.utils.vector import DEFAULT_SEED, make_x

log = logging.getLogger("spmv_scpa_tpu.bench")


@dataclass
class RunConfig:
    out_dir: str
    debug: bool = False
    strategies: list[str] | None = None   # None = all registered device
    seed: int = DEFAULT_SEED
    host_parallel: bool = False           # also run native-OMP (omp rows)
    # thread sweep for the OpenMP rows — the reference's sweep verbatim
    # (main.c:177-180); runs regardless of core count
    omp_threads: tuple = (2, 4, 8, 16, 32, 40)
    skip_serial_hll: bool = False
    # multi-vector SpMM widths (BASELINE.json config 3); () = SpMV
    # only. No reference analog — the reference is single-vector.
    spmm_cols: tuple = ()
    # also benchmark the distributed row-sharded path (config 5) on
    # the compute platform's devices, logged under strategy id 9
    distributed: bool = False
    # Filled by run_benchmarks: (strategy, cell, reason) for every cell
    # a strategy refused (``refused: ...``, e.g. a padding bound) or
    # failed on. A sweep must not silently "pass" with strategies
    # missing: the CLI exits non-zero on any failure.
    skipped: list = field(default_factory=list)

    @property
    def failed(self) -> list:
        return [s for s in self.skipped if not s[2].startswith("refused")]


@dataclass
class RowResult:
    strategy: str
    fmt: str
    cell: str | None           # "cols=8", "devices=4"; None for SpMV
    bench: BenchResult
    rel_err: float | None = None
    meta: dict = field(default_factory=dict)


def _fmt_blocks(prep):
    nb = prep.meta.get("num_blocks")
    return None if nb is None else int(nb)


def _attempt(cfg, name, cell, run):
    """Run one benchmark cell; a ``ValueError`` is the strategy
    refusing the matrix, any other error a failure. Both are recorded
    in ``cfg.skipped``; validation errors abort the run."""
    try:
        return run()
    except ValidationError:
        raise
    except ValueError as e:
        cfg.skipped.append((name, cell, f"refused: {e}"))
        log.warning("%s (%s) refused: %s", name, cell, e)
    except Exception as e:
        cfg.skipped.append((name, cell, f"{type(e).__name__}: {e}"))
        log.error("%s (%s) failed: %s", name, cell, e)
    return None


def run_benchmarks(A: CSR, cfg: RunConfig) -> list[RowResult]:
    os.makedirs(cfg.out_dir, exist_ok=True)
    results: list[RowResult] = []
    x = make_x(A.n, seed=cfg.seed)

    with CsvLogger(cfg.out_dir) as logger:
        # --- serial golden (main.c:126-146) ---
        prep = get_strategy("oracle-csr").prepare(A)
        r = time_host_fn(prep.fn, x, nnz=A.nnz)
        golden = r.data
        logger.log_serial(matrix=A.name, fmt="CSR", rows=A.m, cols=A.n,
                          nnz=A.nnz, num_blocks=None,
                          duration_ms=r.duration_ms, gflops=r.gflops)
        results.append(RowResult("oracle-csr", "CSR", None, r, 0.0))
        log.info("serial CSR: %.3f ms (%.3f GFLOPS)", r.duration_ms, r.gflops)

        # --- serial HLL (main.c:150-171) ---
        if not cfg.skip_serial_hll:
            prep = get_strategy("oracle-ell").prepare(A)
            r = time_host_fn(prep.fn, x, nnz=A.nnz)
            rel = _check(cfg, golden, r.data, "oracle-ell")
            logger.log_serial(matrix=A.name, fmt="HLL", rows=A.m, cols=A.n,
                              nnz=A.nnz, num_blocks=_fmt_blocks(prep),
                              duration_ms=r.duration_ms, gflops=r.gflops)
            results.append(RowResult("oracle-ell", "HLL", None, r, rel))

        # --- host-parallel rows (OpenMP analog, main.c:177-180) ---
        if cfg.host_parallel:
            _run_host_parallel(A, x, golden, cfg, logger, results)

        # --- device strategies (CUDA analog, main.c:255-359) ---
        names = cfg.strategies or list_strategies(backend="xla") + \
            list_strategies(backend="pallas")
        for name in names:
            spec = get_strategy(name)
            if spec.backend == "host" or spec.spmm_only:
                continue  # multi-vector strategies run in _run_spmm

            def run(spec=spec):
                prep = spec.prepare(A)
                return prep, time_prepared(prep, x)

            got = _attempt(cfg, name, "spmv", run)
            if got is None:
                continue
            prep, r = got
            rel = _check(cfg, golden, r.data, name,
                         rtol=prep.meta.get("rtol"))
            # the cuda.csv warps_per_block column: the kernel's warp
            # count where it has one, 0 for XLA-compiled strategies
            warps = int(prep.meta.get("num_warps", 0))
            logger.log_device(matrix=A.name, fmt=spec.fmt, kernel=name,
                              warps_per_block=warps, rows=A.m, cols=A.n,
                              nnz=A.nnz, num_blocks=_fmt_blocks(prep),
                              duration_ms=r.duration_ms, gflops=r.gflops)
            results.append(RowResult(name, spec.fmt, None, r, rel,
                                     dict(prep.meta)))
            log.info("%-16s %10.4f ms %8.2f GFLOPS", name, r.duration_ms,
                     r.gflops)

        # --- distributed row-sharded SpMV (ABSENT-IN-REF; BASELINE
        # config 5) — logged under its reserved strategy id ---
        if cfg.distributed:
            _run_distributed(A, x, golden, cfg, logger, results)

        # --- multi-vector SpMM (config 3; no reference analog) ---
        if cfg.spmm_cols:
            _run_spmm(A, cfg, logger, results)
    if cfg.skipped:
        log.warning("%d cell(s) produced no row: %s", len(cfg.skipped),
                    "; ".join(f"{n}({c}): {why}"
                              for n, c, why in cfg.skipped))
    return results


def _run_spmm(A, cfg, logger, results):
    """Multi-vector SpMM sweep over the ``cols`` axis. The golden is
    ALWAYS computed and every row validated (the reference validates
    its whole sweep in -d mode, main.c:282-293)."""
    from spmv_scpa_tpu.ops.oracle import spmm_oracle

    name = "xla-csr-segsum-spmm"
    spec = get_strategy(name)
    for cols in cfg.spmm_cols:
        X = make_x(A.n, cols=cols, seed=cfg.seed)
        golden = spmm_oracle(A, X)

        def run(cols=cols, X=X):
            prep = spec.prepare(A, cols=cols)
            return prep, time_prepared(prep, X)

        got = _attempt(cfg, name, f"cols={cols}", run)
        if got is None:
            continue
        prep, r = got
        rel = validate_result(golden, r.data, what=f"{name} cols={cols}")
        logger.log_device(matrix=A.name, fmt=spec.fmt, kernel=name,
                          warps_per_block=cols, rows=A.m, cols=A.n,
                          nnz=A.nnz, num_blocks=_fmt_blocks(prep),
                          duration_ms=r.duration_ms, gflops=r.gflops)
        results.append(RowResult(name, spec.fmt, f"cols={cols}", r, rel,
                                 dict(prep.meta)))
        log.info("%-20s cols=%-3d %10.4f ms %8.2f GFLOPS", name, cols,
                 r.duration_ms, r.gflops)


def _run_distributed(A, x, golden, cfg, logger, results):
    """Row-sharded distributed SpMV row (strategy id 9) over every
    device of the compute platform: the GPUs of this host, or the
    virtual CPU devices under test."""
    import jax

    from spmv_scpa_tpu.parallel.distributed import (make_mesh,
                                                    prepare_row_sharded)
    from spmv_scpa_tpu.utils.platform import device_info

    devices = jax.devices(device_info().platform)
    name = "distributed-rowshard"

    def run():
        dist = prepare_row_sharded(A, mesh=make_mesh(devices=devices))
        return time_device_fn(dist.raw, x, args=dist.args, nnz=A.nnz)

    r = _attempt(cfg, name, f"devices={len(devices)}", run)
    if r is None:
        return
    rel = _check(cfg, golden, r.data, name)
    logger.log_device(matrix=A.name, fmt="CSR", kernel=name,
                      warps_per_block=len(devices), rows=A.m, cols=A.n, nnz=A.nnz,
                      num_blocks=None, duration_ms=r.duration_ms,
                      gflops=r.gflops)
    results.append(RowResult(name, "CSR", f"devices={len(devices)}", r,
                             rel))
    log.info("%s devices=%d %10.4f ms %8.2f GFLOPS", name, len(devices),
             r.duration_ms, r.gflops)


def _run_host_parallel(A, x, golden, cfg, logger, results):
    """Native C++/OpenMP rows → omp.csv: the reference's OpenMP
    benchmarks (csr.c:278-339, hll.c:178-211) as real OpenMP kernels
    (native/spmv_omp.cpp) swept over thread counts (main.c:177-180).
    Falls back to XLA-on-CPU when the native toolchain is missing.
    A library built without OpenMP refuses every thread count above 1,
    so those cells are recorded as refusals, not as rows. A container
    with fewer cores than threads logs flat rows."""
    from spmv_scpa_tpu.ops import native_omp

    if not native_omp.available():
        _run_host_parallel_xla(A, x, golden, cfg, logger, results)
        return

    from spmv_scpa_tpu.formats.ell import csr_to_ell

    try:
        E = csr_to_ell(A, slice_h=32, col_major=True, pad_mode="last")
    except Exception:
        E = None
    for nt in cfg.omp_threads:
        variants = [
            ("omp_csr_guided", "CSR", None,
             lambda: native_omp.make_csr_omp_guided(A, nt)),
            ("omp_csr_nnz", "CSR", None,
             lambda: native_omp.make_csr_omp_nnz(A, nt)),
        ]
        if E is not None:
            variants.append(("omp_ell", "HLL", E.num_slices,
                             lambda: native_omp.make_ell_omp(E, nt)))
        for bench_name, fmt, nblocks, make in variants:
            r = _attempt(cfg, bench_name, f"threads={nt}",
                         lambda: time_host_fn(make(), x, nnz=A.nnz))
            if r is None:
                continue
            rel = _check(cfg, golden, r.data, f"{bench_name} nt={nt}")
            logger.log_omp(matrix=A.name, fmt=fmt, bench=bench_name,
                           rows=A.m, cols=A.n, nnz=A.nnz,
                           num_blocks=nblocks, num_threads=nt,
                           duration_ms=r.duration_ms, gflops=r.gflops)
            results.append(RowResult(f"{bench_name}@{nt}", fmt, None,
                                     r, rel))
            log.info("%-16s nt=%-3d %10.4f ms %8.2f GFLOPS",
                     bench_name, nt, r.duration_ms, r.gflops)


def _run_host_parallel_xla(A, x, golden, cfg, logger, results):
    """XLA-on-CPU fallback rows (no native toolchain): one row at the
    pool size."""
    import jax

    nthreads = os.cpu_count() or 1
    cpu = jax.devices("cpu")[0]
    for name, fmt, bench_name in (
            ("xla-csr-segsum", "CSR", "xla_guided"),
            ("xla-ell-cm", "HLL", "xla_ell")):
        try:
            with jax.default_device(cpu):
                prep = get_strategy(name).prepare(A)
                r = time_prepared(prep, x)
        except Exception as e:
            log.warning("host-parallel %s skipped: %s", name, e)
            continue
        rel = _check(cfg, golden, r.data, f"host {name}")
        logger.log_omp(matrix=A.name, fmt=fmt, bench=bench_name,
                       rows=A.m, cols=A.n, nnz=A.nnz,
                       num_blocks=_fmt_blocks(prep), num_threads=nthreads,
                       duration_ms=r.duration_ms, gflops=r.gflops)
        results.append(RowResult(name + "@cpu", fmt, None, r, rel))


def _check(cfg, golden, got, what, rtol=None) -> float | None:
    if not cfg.debug:
        return None
    kw = {"rtol": rtol} if rtol else {}
    return validate_result(golden, got, what=what, **kw)
