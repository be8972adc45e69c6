#!/usr/bin/env python
"""Headline benchmark: SpMV GFLOP/s on the flagship (ML_Laplace-scale)
matrix through the strategy ``pick_auto`` chooses, on one GPU.

Prints ONE JSON line: the metric, the strategy and its per-call time,
roofline shares (bytes the kernel streams over the bandwidth of a plain
copy measured in the same process, and over the card's published peak;
``vs_ideal_roofline`` counts only the format-free 8 B/nnz), and the
device as JAX reports it beside the card's name and power limit.
Exits non-zero without a GPU.

The SuiteSparse files cannot be downloaded here, so the flagship is the
ML_Laplace structural stand-in from spmv_scpa_tpu/testing.py
(``FLAGSHIP_SPEC``: the ``stencil`` archetype, 377k rows, ~22.6M nnz,
~60 nnz/row in repeated contiguous runs at fixed offsets).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    from spmv_scpa_tpu.bench.roofline import (measure_copy_bw,
                                              peak_hbm_gbs, roofline)
    from spmv_scpa_tpu.bench.timing import time_prepared
    from spmv_scpa_tpu.cli import parse_synth_spec
    from spmv_scpa_tpu.ops.oracle import spmv_oracle
    from spmv_scpa_tpu.ops.registry import get_strategy, pick_auto
    from spmv_scpa_tpu.testing import FLAGSHIP_SPEC
    from spmv_scpa_tpu.utils.platform import (configure_compile_cache,
                                              gpu_card_line, require_gpu)
    from spmv_scpa_tpu.utils.validation import validate_result
    from spmv_scpa_tpu.utils.vector import make_x

    configure_compile_cache()
    try:
        info = require_gpu()
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    A = parse_synth_spec(FLAGSHIP_SPEC)
    x = make_x(A.n)
    name = pick_auto(A)
    prep = get_strategy(name).prepare(A)
    r = time_prepared(prep, x)
    rel = validate_result(spmv_oracle(A, x), r.data, rtol=1e-5, abs_l2=0.0,
                          what=name)
    rep = roofline(prep, r.duration_ms, r.gflops, m=A.m, x_bytes=A.n * 4,
                   y_bytes=A.m * 4, copy_bw=measure_copy_bw(),
                   peak_bw=peak_hbm_gbs(info.kind))
    print(json.dumps({
        "metric": "spmv_gflops_ml_laplace_like",
        "value": r.gflops,
        "unit": "GFLOP/s",
        "strategy": name,
        "ms": r.duration_ms,
        "rel_err": rel,
        "vs_copy_roofline": rep.fraction,
        "vs_peak_roofline": rep.fraction_peak,
        "vs_ideal_roofline": rep.fraction_ideal,
        "copy_bw_gbs": rep.copy_bw_gbs,
        "card": gpu_card_line(),
        "device": info.as_dict(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
