#!/usr/bin/env python
"""Smoke run of the SpMV main path on a GPU.

    python chip_smoke.py               # phases (a)-(g) on one GPU
    python chip_smoke.py --four-cards  # phase (h) only, on four GPUs

Phases, all in this one process (a JAX process reserves most of a
card's memory, so a second one could not use the card):

  (a) the device as JAX reports it, and the card's name and power limit
  (b) the native libraries rebuilt from source (``make -B -C native``)
  (c) the flagship stencil through ``spmv_scpa_tpu.spmv`` and through
      every registered device strategy, each against the fp64 oracle
  (d) multi-vector SpMM at 8 and 64 right-hand sides
  (e) the webbase and powerlaw archetypes through ``auto``
  (f) the CLI end to end with ``-d`` on the flagship
  (g) host-clock times of ``pallas-hell`` against the XLA paths, in
      ten rounds that alternate the order
  (h) ``--four-cards``: the row-sharded path over 4 GPUs against the
      oracle and against the same path on 1 GPU

Every comparison uses the relative L2 gate alone, at a stated
tolerance: 1e-5 for f32 strategies (f32 accumulation over at most a
few hundred terms gives ~1e-6; TF32 would give ~1e-3) and the
strategy's own ``meta["rtol"]`` where it declares one (1e-9 for
``xla-ell-df64``). A failed phase ends the run with a non-zero exit,
as does a process that finds no GPU. The last line of a passing run is
one JSON object: ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
F32_RTOL = 1e-5
CLI_OUT = os.path.join(ROOT, "out", "chip_smoke")


def _check(name, expected, got, rtol):
    from spmv_scpa_tpu.utils.validation import validate_result
    rel = validate_result(expected, got, rtol=rtol, abs_l2=0.0, what=name)
    print(f"  {name:28s} rel_err={rel:.3e} (rtol {rtol:g}) ok", flush=True)


def phase_device():
    from spmv_scpa_tpu.utils.platform import gpu_card_line, require_gpu
    info = require_gpu()
    print(f"  platform={info.platform} kind={info.kind} "
          f"count={info.count}")
    card = gpu_card_line()
    print(card, flush=True)     # as nvidia-smi gives it, unprefixed
    return info, card


def phase_native():
    subprocess.run(["make", "-B", "-s", "-C", os.path.join(ROOT, "native")],
                   check=True, timeout=300)
    from spmv_scpa_tpu.io import native
    from spmv_scpa_tpu.ops import native_omp
    if not (native.available() and native_omp.available()):
        raise RuntimeError("native libraries did not load after the build")
    print("  libmtxparser.so and libspmvomp.so rebuilt and loaded",
          flush=True)
    if native_omp.openmp():
        print(f"  OpenMP: yes, {native_omp.max_threads()} threads",
              flush=True)
    else:
        print("  OpenMP: NO (the compiler has no -fopenmp): the host "
              "kernels run on one thread and thread counts above 1 are "
              "refused", flush=True)


def phase_flagship(A, x, gold):
    import jax

    import spmv_scpa_tpu as sx
    from spmv_scpa_tpu.ops.registry import get_strategy, pick_auto

    auto = pick_auto(A)
    _check(f"spmv(auto -> {auto})", gold, sx.spmv(A, x), F32_RTOL)
    for name in sx.list_strategies():
        spec = get_strategy(name)
        if spec.backend == "host" or spec.spmm_only:
            continue
        try:
            prep = spec.prepare(A)
        except ValueError as e:          # e.g. xla-dense past its size
            print(f"  {name:28s} refused: {e}", flush=True)
            continue
        _check(name, gold, prep.fn(x), prep.meta.get("rtol", F32_RTOL))
        if name == auto:
            mem = jax.jit(prep.raw).lower(x, *prep.args).compile() \
                .memory_analysis()
            print(f"  memory_analysis({name}): {mem}", flush=True)


def phase_spmm():
    from spmv_scpa_tpu.cli import parse_synth_spec
    from spmv_scpa_tpu.ops.oracle import spmm_oracle
    from spmv_scpa_tpu.ops.registry import get_strategy
    from spmv_scpa_tpu.utils.vector import make_x

    # cant-scale banded matrix (scripts/results.py SYNTH_SUITE): its
    # 64-wide X[ja] stays a few GB on the host oracle and the device
    A = parse_synth_spec(
        "synth:banded:m=62000,row_nnz=64,bandwidth=300,runs=8,seed=2")
    print(f"  [{A.name}] {A.m} x {A.n}, nnz={A.nnz}")
    for cols in (8, 64):
        X = make_x(A.n, cols=cols)
        prep = get_strategy("xla-csr-segsum-spmm").prepare(A, cols=cols)
        _check(f"xla-csr-segsum-spmm cols={cols}", spmm_oracle(A, X),
               prep.fn(X), F32_RTOL)


def phase_archetypes():
    import spmv_scpa_tpu as sx
    from spmv_scpa_tpu.cli import parse_synth_spec
    from spmv_scpa_tpu.ops.registry import pick_auto
    from spmv_scpa_tpu.utils.vector import make_x

    for spec in ("synth:webbase:m=1000000,seed=7",
                 "synth:powerlaw:m=100000,n=100000,avg_nnz=8,seed=5"):
        A = parse_synth_spec(spec)
        x = make_x(A.n)
        _check(f"{A.name[:14]} auto -> {pick_auto(A)}",
               sx.spmv_oracle(A, x), sx.spmv(A, x), F32_RTOL)


def phase_cli():
    from spmv_scpa_tpu import cli
    from spmv_scpa_tpu.testing import FLAGSHIP_SPEC

    os.makedirs(CLI_OUT, exist_ok=True)
    for f in ("serial.csv", "omp.csv", "cuda.csv"):
        if os.path.exists(os.path.join(CLI_OUT, f)):
            os.remove(os.path.join(CLI_OUT, f))
    rc = cli.main(["-m", FLAGSHIP_SPEC, "-o", CLI_OUT, "-d"])
    if rc != 0:
        raise RuntimeError(f"cli exited {rc}")
    with open(os.path.join(CLI_OUT, "cuda.csv")) as f:
        rows = f.read().splitlines()[1:]
    if not rows:
        raise RuntimeError("cli wrote no cuda.csv rows")
    print(f"  cli exit 0, {len(rows)} cuda.csv rows", flush=True)


def _host_ms(fn, x, calls=20, samples=15):
    """Median over ``samples`` of the host-clock time of ``calls``
    back-to-back calls ended by ``block_until_ready``, per call."""
    fn(x).block_until_ready()
    ts = []
    for _ in range(samples):
        t0 = time.perf_counter()
        for _ in range(calls):
            y = fn(x)
        y.block_until_ready()
        ts.append((time.perf_counter() - t0) / calls)
    ts.sort()
    return ts[len(ts) // 2] * 1e3


def phase_times(A, x, card):
    import jax
    import numpy as np

    from spmv_scpa_tpu.ops.registry import get_strategy

    xd = jax.device_put(x.astype("float32"))
    fns = {}
    for name in ("pallas-hell", "xla-csr-segsum", "xla-ell-cm"):
        prep = get_strategy(name).prepare(A)
        jitted = jax.jit(prep.raw)
        fns[name] = (lambda v, f=jitted, a=prep.args: f(v, *a))
    rounds = 10
    times = {name: [] for name in fns}
    for rnd in range(rounds):          # alternate the order each round
        order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
        for name in order:
            times[name].append(_host_ms(fns[name], xd))
    hell_ts = times["pallas-hell"]
    for name, ts in times.items():
        q1, med, q3 = np.percentile(ts, [25, 50, 75])
        wins = ("" if name == "pallas-hell" else
                f", pallas-hell faster in "
                f"{sum(h < t for h, t in zip(hell_ts, ts))}/{rounds}")
        print(f"  {name:16s} median {med:.4f} ms (quartiles {q1:.4f}, "
              f"{q3:.4f}{wins}) [{card}]", flush=True)


def phase_four_cards(A, x, gold, card, devices=None):
    import jax
    import numpy as np

    from spmv_scpa_tpu.parallel.distributed import (make_mesh,
                                                    prepare_row_sharded)

    devs = devices or jax.devices("gpu")
    if len(devs) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, found {len(devs)}")
    d4 = prepare_row_sharded(A, mesh=make_mesh(devices=devs[:4]))
    placed = {s.device for s in d4.args[0].addressable_shards}
    if len(placed) != 4:
        raise RuntimeError(f"shards landed on {len(placed)} devices")
    print(f"  shards on {sorted(d.id for d in placed)}", flush=True)
    y4 = np.asarray(d4.fn(x), np.float64)
    _check("rowshard 4 GPUs vs oracle", gold, y4, F32_RTOL)
    d1 = prepare_row_sharded(A, mesh=make_mesh(devices=devs[:1]))
    y1 = np.asarray(d1.fn(x), np.float64)
    _check("rowshard 4 GPUs vs 1 GPU", y1, y4, F32_RTOL)
    xd = jax.device_put(x.astype("float32"))
    for tag, d in (("1 GPU", d1), ("4 GPUs", d4)):
        print(f"  rowshard {tag:7s} {_host_ms(d.fn, xd):.4f} ms [{card}]",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the row-sharded path on 4 GPUs")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    try:
        from spmv_scpa_tpu.cli import parse_synth_spec
        from spmv_scpa_tpu.ops.oracle import spmv_oracle
        from spmv_scpa_tpu.testing import FLAGSHIP_SPEC
        from spmv_scpa_tpu.utils.platform import configure_compile_cache
        from spmv_scpa_tpu.utils.vector import make_x
    except ImportError as e:
        print(f"chip_smoke: the spmv_scpa_tpu package is missing: {e}",
              file=sys.stderr)
        return 2
    configure_compile_cache()

    phase = "a"
    try:
        print("(a) device", flush=True)
        info, card = phase_device()
        phase = "flagship set-up"
        t0 = time.perf_counter()
        A = parse_synth_spec(FLAGSHIP_SPEC)
        x = make_x(A.n)
        gold = spmv_oracle(A, x)
        print(f"[{A.name}] {A.m} x {A.n}, nnz={A.nnz} "
              f"({time.perf_counter() - t0:.1f} s to build)", flush=True)
        if args.four_cards:
            phase = "h"
            print("(h) row-sharded SpMV on four GPUs", flush=True)
            phase_four_cards(A, x, gold, card)
        else:
            steps = (("b", "native libraries", phase_native, ()),
                     ("c", "flagship strategies", phase_flagship,
                      (A, x, gold)),
                     ("d", "SpMM", phase_spmm, ()),
                     ("e", "archetypes through auto", phase_archetypes, ()),
                     ("f", "CLI", phase_cli, ()),
                     ("g", "host-clock times", phase_times, (A, x, card)))
            for phase, title, fn, fargs in steps:
                t0 = time.perf_counter()
                print(f"({phase}) {title}", flush=True)
                fn(*fargs)
                print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    except Exception as e:  # any failed phase fails the run
        print(f"chip_smoke: phase ({phase}) failed: {type(e).__name__}: "
              f"{e}", file=sys.stderr)
        return 1
    import jax
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
