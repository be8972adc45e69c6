#!/usr/bin/env python
"""Parallel-scaling study — the reference's OpenMP thread sweep
(src/main.c:177-180: threads in {2,4,8,16,32,40}) re-expressed as a
device axis: devices in a 1-D mesh, swept over {1,2,4,8} on the
virtual CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count),
through the distributed row-sharded SpMV (parallel/distributed.py).
CPU devices give relative scaling only; the GPU path is
``chip_smoke.py --four-cards``.

Rows land in omp.csv (schema: bench/logger.py) with
``num_threads`` = device count and bench ``mesh_rowshard``; serial.csv
gets the fp64 oracle row so plots.py can derive
speedup-vs-parallelism per nnz bin (reference scripts/plots.py:186-248).

Run: python scripts/scaling.py -o res/benchmarks
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# must precede any backend initialization (tests/conftest.py pattern)
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

DEVICE_COUNTS = (1, 2, 4, 8)

SUITE = [
    ("synth:banded:m=4000,row_nnz=9,bandwidth=48,runs=3,seed=1", {}),
    ("synth:banded:m=62000,row_nnz=64,bandwidth=300,runs=8,seed=2", {}),
    ("synth:random:m=30000,n=30000,density=0.0005,seed=4", {}),
    ("synth:powerlaw:m=100000,n=100000,avg_nnz=8,seed=5", {}),
    ("synth:stencil:m=120000,points=6,run_len=12,bandwidth=500,seed=3", {}),
]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-o", "--out", required=True, help="results dir")
    ap.add_argument("--devices", default=None,
                    help="comma list of mesh sizes (default 1,2,4,8)")
    ap.add_argument("-m", "--matrix", default=None,
                    help="single matrix spec (synth:... or .mtx path) "
                         "instead of the built-in suite")
    args = ap.parse_args()
    counts = (tuple(int(c) for c in args.devices.split(","))
              if args.devices else DEVICE_COUNTS)

    import jax
    import numpy as np

    jax.config.update("jax_default_device", jax.devices("cpu")[0])

    from spmv_scpa_tpu.bench.logger import CsvLogger
    from spmv_scpa_tpu.bench.timing import time_device_fn, time_host_fn
    from spmv_scpa_tpu.cli import parse_synth_spec
    from spmv_scpa_tpu.ops.oracle import spmv_oracle
    from spmv_scpa_tpu.ops.registry import get_strategy
    from spmv_scpa_tpu.parallel.distributed import (make_mesh,
                                                    prepare_row_sharded)
    from spmv_scpa_tpu.utils.validation import validate_result
    from spmv_scpa_tpu.utils.vector import make_x

    cpus = jax.devices("cpu")
    suite = [(args.matrix, {})] if args.matrix else SUITE
    with CsvLogger(args.out) as logger:
        for spec, _ in suite:
            if spec.startswith("synth:"):
                A = parse_synth_spec(spec)
            else:
                from spmv_scpa_tpu.io.loader import load_csr
                A = load_csr(spec)
            x = make_x(A.n)
            gold = spmv_oracle(A, x)
            print(f"=== {A.name} nnz={A.nnz} ===", flush=True)

            prep = get_strategy("oracle-csr").prepare(A)
            r = time_host_fn(prep.fn, x, nnz=A.nnz)
            logger.log_serial(matrix=A.name, fmt="CSR", rows=A.m,
                              cols=A.n, nnz=A.nnz, num_blocks=None,
                              duration_ms=r.duration_ms, gflops=r.gflops)

            for nd in counts:
                dist = prepare_row_sharded(
                    A, mesh=make_mesh(devices=cpus[:nd]))
                r = time_device_fn(dist.raw, x, args=dist.args, nnz=A.nnz)
                validate_result(gold, r.data, what=f"mesh_rowshard nd={nd}")
                logger.log_omp(matrix=A.name, fmt="CSR",
                               bench="mesh_rowshard", rows=A.m, cols=A.n,
                               nnz=A.nnz, num_blocks=nd, num_threads=nd,
                               duration_ms=r.duration_ms, gflops=r.gflops)
                print(f"  mesh_rowshard devices={nd}: "
                      f"{r.duration_ms:9.3f} ms {r.gflops:7.3f} "
                      "GFLOP/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
