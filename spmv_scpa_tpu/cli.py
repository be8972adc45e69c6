"""Command-line interface — the reference binary's flag surface.

Reference flags (main.c:35-64): ``-m/--matrix`` (path, required),
``-o/--out`` (results dir, required), ``-d/--debug`` (validate against
the serial golden), ``-b/--bench`` (parsed but dead in the reference —
here it actually filters strategies), ``-h/--help``.

Extensions (documented differences):

* ``-m synth:<archetype>:k=v,...`` generates a synthetic matrix
  (no-network environments; archetypes in spmv_scpa_tpu/testing.py).
* ``--list-strategies``, ``--host-parallel``, ``--distributed``,
  ``--spmm-cols``, ``--seed``.

Exit codes are errno-style like the reference's ERR_PTR convention
(err.h:10-12); a run in which any strategy failed (as opposed to
refusing the matrix) exits 1.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from spmv_scpa_tpu.errors import ConfigError, SpmvError


def parse_synth_spec(spec: str):
    """``synth:banded:m=1000,row_nnz=32,seed=1`` → CSR."""
    from spmv_scpa_tpu import testing as synth

    parts = spec.split(":")
    if len(parts) < 2 or parts[0] != "synth":
        raise ConfigError(f"bad synth spec {spec!r}")
    archetype = parts[1]
    if archetype not in synth.ARCHETYPES:
        raise ConfigError(
            f"unknown archetype {archetype!r}; have {sorted(synth.ARCHETYPES)}")
    kwargs = {}
    if len(parts) > 2 and parts[2]:
        for kv in parts[2].split(","):
            k, _, v = kv.partition("=")
            try:
                kwargs[k] = int(v)
            except ValueError:
                try:
                    kwargs[k] = float(v)   # handles 1e-3 etc.
                except ValueError:
                    raise ConfigError(
                        f"bad numeric value {v!r} in synth spec {spec!r}"
                    ) from None
    A = synth.ARCHETYPES[archetype](**kwargs)
    return A.with_name(f"{archetype}_" + "_".join(
        f"{k}{v}" for k, v in sorted(kwargs.items())))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spmv_scpa_tpu",
        description="SpMV benchmark suite "
                    "(CSR/HLL x XLA/Pallas strategies)")
    p.add_argument("-m", "--matrix",
                   help=".mtx path or synth:<archetype>:k=v,...")
    p.add_argument("-o", "--out", help="results directory (CSV logs)")
    p.add_argument("-d", "--debug", action="store_true",
                   help="validate every result against the serial golden")
    p.add_argument("-b", "--bench", default=None,
                   help="comma-separated strategy filter "
                        "(dead flag in the reference, live here)")
    p.add_argument("--spmm-cols", default="0",
                   help="also benchmark multi-vector SpMM at these "
                        "widths (comma list, e.g. 8,32,64; 0 = off)")
    p.add_argument("--seed", type=int, default=42, help="x vector seed")
    p.add_argument("--distributed", action="store_true",
                   help="also benchmark the row-sharded distributed "
                        "path (strategy id 9)")
    p.add_argument("--host-parallel", action="store_true",
                   help="also run the native C++/OpenMP kernels swept "
                        "over thread counts -> omp.csv (falls back to "
                        "one XLA-on-CPU row if the toolchain is "
                        "missing; a build without OpenMP refuses "
                        "thread counts above 1)")
    p.add_argument("--no-cache", action="store_true",
                   help="disable the .npz preprocessed-layout cache "
                        "(the reference re-parses the .mtx every run, "
                        "csr.c:31-171; we cache by default)")
    p.add_argument("--print-result", type=int, default=0, metavar="N",
                   help="print the first N entries of each result "
                        "vector (reference: print_result_vector)")
    p.add_argument("--list-strategies", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from spmv_scpa_tpu.utils.platform import configure_compile_cache
    configure_compile_cache()
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(levelname)s %(name)s: %(message)s")

    from spmv_scpa_tpu.ops.registry import get_strategy, list_strategies

    if args.list_strategies:
        for name in list_strategies():
            s = get_strategy(name)
            print(f"{name:18s} fmt={s.fmt:5s} backend={s.backend:6s} "
                  f"ref={s.cite}")
        return 0

    if not args.matrix or not args.out:
        print("error: -m/--matrix and -o/--out are required "
              "(see --help)", file=sys.stderr)
        return 2

    try:
        if args.matrix.startswith("synth:"):
            A = parse_synth_spec(args.matrix)
        elif args.no_cache:
            from spmv_scpa_tpu.io.loader import load_csr
            A = load_csr(args.matrix)
        else:
            # default-on .npz layout cache: repeat sweeps skip the
            # parse entirely (SURVEY.md section 5 improvement over the
            # reference's per-run re-parse, csr.c:31-171)
            from spmv_scpa_tpu.io.cache import load_csr_cached
            A = load_csr_cached(args.matrix)
    except SpmvError as e:
        print(f"error loading matrix: {e}", file=sys.stderr)
        return e.code
    except OSError as e:
        print(f"error reading {args.matrix}: {e}", file=sys.stderr)
        return 1

    print(f"[{A.name}] {A.m} x {A.n}, nnz={A.nnz}")

    from spmv_scpa_tpu.bench.runner import RunConfig, run_benchmarks

    cfg = RunConfig(
        out_dir=args.out,
        debug=args.debug,
        strategies=args.bench.split(",") if args.bench else None,
        seed=args.seed,
        host_parallel=args.host_parallel,
        spmm_cols=tuple(c for c in
                        (int(s) for s in str(args.spmm_cols).split(","))
                        if c > 0),
        distributed=args.distributed,
    )
    try:
        results = run_benchmarks(A, cfg)
    except SpmvError as e:
        print(f"benchmark failed: {e}", file=sys.stderr)
        return e.code

    for r in results:
        err = "" if r.rel_err is None else f"  rel_err={r.rel_err:.2e}"
        cell = "" if r.cell is None else f" {r.cell}"
        print(f"  {r.strategy:18s}{cell:10s} {r.bench.duration_ms:10.4f} ms"
              f" {r.bench.gflops:9.3f} GFLOPS{err}")
        if args.print_result and r.bench.data is not None:
            head = np.array2string(
                np.asarray(r.bench.data).ravel()[:args.print_result],
                precision=6, max_line_width=100)
            print(f"    y[:{args.print_result}] = {head}")
    failed = cfg.failed
    for entry in cfg.skipped:
        name, cell, why = entry
        print(f"{'FAILED' if entry in failed else 'skipped'}: {name} "
              f"({cell}): {why}", file=sys.stderr)
    print(f"CSV logs appended under {cfg.out_dir}/")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
