#!/usr/bin/env python
"""Batch benchmark driver — the scripts/results.py analog
(reference: scripts/results.py:5-40).

Iterates matrices (``*.mtx`` files in a directory, and/or the built-in
synthetic suite for network-less environments) and runs the benchmark
CLI for each, ``-i`` times; CSV rows accumulate across iterations in
one results dir (append-mode logger), medians are taken by plots.py.

Unlike the reference (one subprocess per run, results.py:23-26) the
default is in-process execution to amortize JAX init/compile; pass
``--subprocess`` for the reference's isolation semantics.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spmv_scpa_tpu.testing import FLAGSHIP_SPEC  # noqa: E402

# The synthetic stand-ins for the reference's 30-matrix SuiteSparse
# suite (download-matrices.py:7-38) — same structural archetypes,
# usable with zero network egress.
SYNTH_SUITE = [
    "synth:banded:m=4000,row_nnz=9,bandwidth=48,runs=3,seed=1",       # olm1000-ish
    "synth:banded:m=62000,row_nnz=64,bandwidth=300,runs=8,seed=2",    # cant-ish
    FLAGSHIP_SPEC,                                                    # ML_Laplace-ish
    "synth:random:m=30000,n=30000,density=0.0005,seed=4",             # mac_econ-ish
    "synth:powerlaw:m=100000,n=100000,avg_nnz=8,seed=5",              # no-locality stress
    "synth:webbase:m=1000000,seed=7",                                 # webbase-1M stand-in
    "synth:amazon:m=262000,seed=6",                                   # amazon0302 stand-in
]


def compare(specs: list[str], strategies: list[str], out: str | None,
            debug: bool = True) -> int:
    """Per-archetype strategy comparison — ONE best cell per strategy
    per matrix, validated, printed as a markdown table.

    ``auto`` as a strategy name times whatever ``pick_auto`` routes to
    (labelled ``auto->%s``), so the table shows both the per-strategy
    frontier and where the router actually lands.
    """
    import numpy as np

    from spmv_scpa_tpu.bench.timing import time_prepared
    from spmv_scpa_tpu.cli import parse_synth_spec
    from spmv_scpa_tpu.ops.oracle import spmv_oracle
    from spmv_scpa_tpu.ops.registry import get_strategy, pick_auto
    from spmv_scpa_tpu.utils.platform import device_info
    from spmv_scpa_tpu.utils.validation import validate_result
    from spmv_scpa_tpu.utils.vector import make_x

    print(f"device: {device_info().as_dict()}", flush=True)
    lines = ["| matrix | strategy | ms | GF/s | rel_err |",
             "|---|---|---|---|---|"]
    failures = 0
    for spec in specs:
        if spec.startswith("synth:"):
            A = parse_synth_spec(spec)
        else:
            from spmv_scpa_tpu.io.cache import load_csr_cached
            A = load_csr_cached(spec)
        x = make_x(A.n)
        gold = spmv_oracle(A, x) if debug else None
        print(f"=== {A.name} ({A.m}x{A.n}, nnz={A.nnz}) ===", flush=True)
        for name in strategies:
            label = name
            try:
                if name == "auto":
                    routed = pick_auto(A)
                    label = f"auto->{routed}"
                    s = get_strategy(routed)
                else:
                    s = get_strategy(name)
                prep = s.prepare(A)
                r = time_prepared(prep, x)
                rel = (validate_result(gold, r.data, what=label)
                       if debug else float("nan"))
            except ValueError as e:
                print(f"  {label:24s} refused: {e}", flush=True)
                lines.append(f"| {A.name} | {label} | — | — | refused |")
                continue
            except Exception as e:
                failures += 1
                print(f"  {label:24s} FAILED: {type(e).__name__}: {e}",
                      flush=True)
                lines.append(f"| {A.name} | {label} | — | — | "
                             f"{type(e).__name__} |")
                continue
            print(f"  {label:24s} {r.duration_ms:10.4f} ms "
                  f"{r.gflops:8.2f} GF/s", flush=True)
            lines.append(f"| {A.name} | {label} | {r.duration_ms:.4f} "
                         f"| {r.gflops:.2f} | "
                         f"{rel:.2e} |".replace("nan", "—"))
    table = "\n".join(lines)
    print(table)
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "compare.md"), "a") as f:
            f.write(table + "\n")
    return 1 if failures else 0


COMPARE_STRATEGIES = ["auto", "pallas-hell", "xla-ell-cm",
                      "xla-csr-segsum"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-d", "--matrices-dir", default=None,
                    help="directory of .mtx files")
    ap.add_argument("--synth-suite", action="store_true",
                    help="run the built-in synthetic archetype suite")
    ap.add_argument("--compare", action="store_true",
                    help="one validated cell per strategy per "
                         "matrix, as a markdown table")
    ap.add_argument("-o", "--out", required=True, help="results dir")
    ap.add_argument("-i", "--iterations", type=int, default=3)
    ap.add_argument("--debug", action="store_true",
                    help="validate against golden each run")
    ap.add_argument("--bench", default=None, help="strategy filter")
    ap.add_argument("--subprocess", action="store_true",
                    help="isolate each run in a subprocess "
                         "(reference semantics)")
    ap.add_argument("--host-parallel", action="store_true",
                    help="also run the native OpenMP thread sweep")
    ap.add_argument("--distributed", action="store_true",
                    help="also benchmark the row-sharded path")
    ap.add_argument("--spmm-cols", default="0",
                    help="comma list of SpMM right-hand-side widths "
                         "(forwarded to the CLI; 0 disables)")
    args = ap.parse_args()

    specs: list[str] = []
    if args.matrices_dir:
        specs += sorted(glob.glob(os.path.join(args.matrices_dir, "*.mtx")))
    if args.synth_suite or not specs:
        specs += SYNTH_SUITE

    if args.compare:
        strategies = (args.bench.split(",") if args.bench
                      else COMPARE_STRATEGIES)
        return compare(specs, strategies, args.out, debug=True)

    failures = 0
    for spec in specs:
        for it in range(args.iterations):
            print(f"=== {spec} (iter {it + 1}/{args.iterations}) ===",
                  flush=True)
            argv = ["-m", spec, "-o", args.out]
            if args.debug:
                argv.append("-d")
            if args.bench:
                argv += ["-b", args.bench]
            if args.host_parallel:
                argv.append("--host-parallel")
            if args.distributed:
                argv.append("--distributed")
            if args.spmm_cols and args.spmm_cols != "0":
                argv += ["--spmm-cols", str(args.spmm_cols)]
            if args.subprocess:
                rc = subprocess.run(
                    [sys.executable, "-m", "spmv_scpa_tpu.cli", *argv],
                    cwd=os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__)))).returncode
            else:
                from spmv_scpa_tpu.cli import main as cli_main
                rc = cli_main(argv)
            if rc != 0:
                failures += 1
                print(f"!!! run failed rc={rc}: {spec}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
