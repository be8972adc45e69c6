"""Strategy registry — the kernel-strategy axis of the framework.

The reference enumerates (backend x format x work-assignment)
strategies via function-pointer dispatch (``compute_benchmark_csr``,
csr.c:182-199; kernel lists in main.c:259-263, 310-315). Here each
strategy is a named entry with a ``prepare`` step (host preprocessing →
device arrays) and a jitted ``fn(x) -> y``, so benchmarks measure only
the kernel, like the reference's cudaEvent timing of the bare launch
(cuda_csr.cu:224-226).

Strategy-name mapping to the reference (SURVEY.md section 2 table):

=====================  =====================================================
 name                   reference analog
=====================  =====================================================
 oracle-csr             serial CSR golden (csr.c:201-216)
 oracle-ell             serial HLL golden (hll.c:127-150)
 xla-csr-segsum         OMP guided / CUDA k0 thread-per-row: flat nnz
                        stream, dynamic balance (csr.c:286-293,
                        cuda_csr.cu:19-31)
 xla-ell-rm             CUDA HLL k0 thread-per-row row-major
                        (cuda_hll.cu:19-43)
 xla-ell-cm             CUDA HLL k1 thread-per-row col-major, the
                        coalesced/lane-contiguous layout
                        (cuda_hll.cu:49-72)
 xla-dense              tiny-matrix regime (launch-bound, SURVEY 6)
 pallas-hell            CUDA HLL k1 thread-per-row col-major with
                        per-slice widths, through Pallas/Triton
                        (cuda_hll.cu:49-72)
 xla-ell-df64           fp64-equivalence via double-float arithmetic
                        (the reference computes natively in fp64)
 xla-csr-segsum-spmm    multi-vector SpMM (no reference analog;
                        BASELINE.json config 3)
=====================  =====================================================
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from spmv_scpa_tpu.formats.csr import CSR


@dataclass
class Prepared:
    """A strategy instantiated for one matrix: device-ready closure plus
    bookkeeping for roofline/CSV reporting."""

    strategy: str
    matrix: str
    fn: Callable[[Any], Any]          # fn(x) -> y (jitted+bound or host)
    on_device: bool
    nnz: int
    # Raw traceable fn(x, *args) + the device-array args, for device
    # strategies. Arrays travel as jit ARGUMENTS (baking them in as
    # closure constants re-ships gigabytes per compile); the bench
    # layer embeds raw in an in-jit timing loop (bench/timing.py).
    raw: Callable[..., Any] | None = None
    args: tuple = ()
    # Optional input packer (host x -> device input, e.g. df64 hi/lo
    # stacking) and output post-processor (device out -> np y).
    prep_x: Callable[[Any], Any] | None = None
    post: Callable[[Any], Any] | None = None
    # Bytes the kernel must stream from HBM per call (matrix data only,
    # excluding x/y), for roofline accounting. 0 if unknown.
    hbm_bytes: int = 0
    meta: dict = field(default_factory=dict)


@dataclass(frozen=True)
class StrategySpec:
    name: str
    fmt: str                          # CSR | HLL | DENSE
    backend: str                      # host | xla | pallas
    cite: str                         # reference file:line analog
    prepare: Callable[..., Prepared] = None
    spmm: bool = False                # supports multi-column x
    spmm_only: bool = False           # REQUIRES 2-D (n, cols) input


_REGISTRY: dict[str, StrategySpec] = {}


def register(spec: StrategySpec) -> StrategySpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"duplicate strategy {spec.name!r}")
    _REGISTRY[spec.name] = spec
    return spec


def get_strategy(name: str) -> StrategySpec:
    _ensure_builtin()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown strategy {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def list_strategies(backend: str | None = None,
                    fmt: str | None = None) -> list[str]:
    _ensure_builtin()
    return sorted(
        n for n, s in _REGISTRY.items()
        if (backend is None or s.backend == backend)
        and (fmt is None or s.fmt == fmt)
    )


def spmv(A: CSR, x, strategy: str = "auto", **params) -> np.ndarray:
    """One-shot convenience: prepare + run a strategy on (A, x).

    SpMM-only strategies (``spmm_only``, e.g. ``xla-csr-segsum-spmm``)
    accept a 1-D x too: it rides column 0 of a (n, cols) block and the
    matching y column is returned, so every ``list_strategies()`` entry
    is drivable through this one entry point.
    """
    if strategy == "auto":
        strategy = pick_auto(A)
    spec = get_strategy(strategy)
    x = np.asarray(x)
    squeeze = False
    if spec.spmm_only and x.ndim == 1:
        X = np.zeros((x.shape[0], params.get("cols", 8)), x.dtype)
        X[:, 0] = x
        x, squeeze = X, True
    prep = spec.prepare(A, **params)
    y = np.asarray(prep.fn(x), dtype=np.float64)
    return y[:, 0] if squeeze else y


def bind(raw, args, prep_x=None, post=None):
    """jit ``raw`` and bind its device-array args → ``fn(x)``."""
    import jax
    jitted = jax.jit(raw)

    def fn(x):
        xin = prep_x(x) if prep_x else x
        out = jitted(xin, *args)
        return post(out) if post else out

    return fn


# The H100's L2 (50 MB, data sheet). A matrix whose uniform ELL fits
# stays in L2 across repeated calls, so its kernel is short and
# per-call dispatch decides the time.
L2_BYTES = 50 << 20


def uniform_ell_slots(A: CSR, slice_h: int = 32) -> int:
    """Slots of the uniform ELL layout (``xla-ell-*``): every slice of
    ``slice_h`` rows padded to the global longest row. Each slot is 4 B
    of value and 4 B of column in f32."""
    max_len = int(np.diff(A.irp).max(initial=1))
    return -(-A.m // slice_h) * slice_h * max(max_len, 1)


def pick_auto(A: CSR) -> str:
    """Strategy choice from the matrix and the platform alone.

    On a GPU:

    * ``xla-csr-segsum`` when the slot fill of 32-row slices is below
      ``hell.MIN_FILL`` (rows too uneven for any ELL layout); it needs
      no padding at all;
    * else ``xla-ell-cm`` when its uniform layout fits in L2
      (``L2_BYTES``): there every kernel takes at most ~25 us and
      per-call dispatch decides, which costs ~10 us less for the XLA
      fusion than for the Triton kernel (on an H100 ``xla-ell-cm`` was
      faster end to end on the cant-scale, random and 40k-row amazon
      archetypes, the last although its kernel took 3x as long;
      PERF.md);
    * else ``pallas-hell`` (per-slice-padded HLL through Triton): every
      slot it reads is 8 B streamed once, while the uniform layout pads
      every slice to the longest row and the segment-sum path pays a
      scatter-add per nonzero.

    Off the GPU, always ``xla-csr-segsum``."""
    from spmv_scpa_tpu.ops import hell
    from spmv_scpa_tpu.utils.platform import device_info

    if (device_info().platform != "gpu" or not A.nnz
            or hell.hell_fill(A) < hell.MIN_FILL):
        return "xla-csr-segsum"
    if uniform_ell_slots(A) * 8 <= L2_BYTES:
        return "xla-ell-cm"
    return "pallas-hell"


# ---------------------------------------------------------------------------
# Built-in strategy registration (lazy to avoid import cycles)
# ---------------------------------------------------------------------------

_BUILTIN_DONE = False


def _ensure_builtin():
    global _BUILTIN_DONE
    if _BUILTIN_DONE:
        return
    _BUILTIN_DONE = True

    import jax.numpy as jnp

    from spmv_scpa_tpu.formats.ell import csr_to_ell
    from spmv_scpa_tpu.ops import hell
    from spmv_scpa_tpu.ops import xla as xla_ops
    from spmv_scpa_tpu.ops.oracle import spmv_oracle

    def _prep_oracle_csr(A: CSR, **_):
        return Prepared("oracle-csr", A.name, lambda x: spmv_oracle(A, x),
                        on_device=False, nnz=A.nnz,
                        hbm_bytes=A.nnz * 12 + (A.m + 1) * 4)

    def _prep_oracle_ell(A: CSR, slice_h: int = 32, **_):
        E = csr_to_ell(A, slice_h=slice_h, col_major=False, pad_mode="neg1")
        return Prepared("oracle-ell", A.name,
                        lambda x: xla_ops.serial_ell(E, x),
                        on_device=False, nnz=A.nnz,
                        hbm_bytes=E.padded_nnz * 12,
                        meta={"num_blocks": E.num_slices})

    def _prep_xla_segsum(A: CSR, dtype=jnp.float32, **_):
        raw, args = xla_ops.make_csr_segsum(A, dtype)
        return Prepared("xla-csr-segsum", A.name, bind(raw, args),
                        on_device=True, nnz=A.nnz, raw=raw, args=args,
                        hbm_bytes=A.nnz * 12)  # val4 + ja4 + rowid4

    def _prep_xla_ell(A: CSR, col_major: bool, slice_h: int = 32,
                      dtype=jnp.float32, max_padded: int = 1 << 28, **_):
        # uniform ELL pads every row to the global max row length —
        # refuse when that explodes (power-law matrices; the reference
        # HLL study shows the same failure mode, SURVEY.md section 6)
        if uniform_ell_slots(A, slice_h) > max_padded:
            raise ValueError(
                f"uniform ELL padding too large (max row "
                f"{int(np.diff(A.irp).max())}); "
                "use xla-csr-segsum or pallas-hell for this matrix")
        E = csr_to_ell(A, slice_h=slice_h, col_major=col_major,
                       pad_mode="last")
        U = E.to_uniform()
        name = "xla-ell-cm" if col_major else "xla-ell-rm"
        raw, args = xla_ops.make_ell_uniform(U, dtype)
        return Prepared(name, A.name, bind(raw, args),
                        on_device=True, nnz=A.nnz, raw=raw, args=args,
                        hbm_bytes=U.ja.size * 8,
                        meta={"num_blocks": E.num_slices,
                              "fill": A.nnz / max(U.ja.size, 1)})

    def _prep_xla_dense(A: CSR, dtype=jnp.float32,
                        max_bytes: int = 512 << 20, **_):
        if A.m * A.n * 4 > max_bytes:
            raise ValueError(
                f"xla-dense: {A.m}x{A.n} dense materialization exceeds "
                f"{max_bytes} B (the tiny-matrix regime only)")
        raw, args = xla_ops.make_dense(A, dtype)
        return Prepared("xla-dense", A.name, bind(raw, args),
                        on_device=True, nnz=A.nnz, raw=raw, args=args,
                        hbm_bytes=A.m * A.n * 4)

    register(StrategySpec("oracle-csr", "CSR", "host",
                          "csr_spmv_serial csr.c:201-216",
                          prepare=_prep_oracle_csr))
    register(StrategySpec("oracle-ell", "HLL", "host",
                          "hll_spmv_serial hll.c:127-150",
                          prepare=_prep_oracle_ell))
    register(StrategySpec("xla-csr-segsum", "CSR", "xla",
                          "csr.c:286-293 + cuda_csr.cu:19-31",
                          prepare=_prep_xla_segsum, spmm=True))
    register(StrategySpec("xla-ell-rm", "HLL", "xla",
                          "cuda_hll.cu:19-43 (row-major)",
                          prepare=lambda A, **kw: _prep_xla_ell(A, False, **kw)))
    register(StrategySpec("xla-ell-cm", "HLL", "xla",
                          "cuda_hll.cu:49-72 (col-major)",
                          prepare=lambda A, **kw: _prep_xla_ell(A, True, **kw)))
    def _prep_xla_ell_df64(A: CSR, slice_h: int = 32,
                           max_padded: int = 1 << 28, **_):
        if uniform_ell_slots(A, slice_h) > max_padded:
            raise ValueError(
                f"uniform ELL padding too large (max row "
                f"{int(np.diff(A.irp).max())}); "
                "df64 path unavailable for this matrix")
        E = csr_to_ell(A, slice_h=slice_h, col_major=True,
                       pad_mode="last")
        U = E.to_uniform()
        raw, args, prep_x, post = xla_ops.make_ell_df64(U)
        return Prepared("xla-ell-df64", A.name,
                        bind(raw, args, prep_x, post),
                        on_device=True, nnz=A.nnz, raw=raw, args=args,
                        prep_x=prep_x, post=post,
                        hbm_bytes=U.ja.size * 12,
                        meta={"num_blocks": E.num_slices,
                              "rtol": 1e-9,
                              "fill": A.nnz / max(U.ja.size, 1)})

    register(StrategySpec("xla-ell-df64", "HLL", "xla",
                          "fp64-equivalence knob (BASELINE.json; "
                          "reference computes in native fp64, csr.h:12)",
                          prepare=_prep_xla_ell_df64))
    def _prep_xla_segsum_spmm(A: CSR, cols: int = 8, dtype=jnp.float32, **_):
        raw, args = xla_ops.make_csr_segsum_spmm(A, dtype)
        return Prepared("xla-csr-segsum-spmm", A.name, bind(raw, args),
                        on_device=True, nnz=A.nnz, raw=raw, args=args,
                        hbm_bytes=A.nnz * 12)

    register(StrategySpec("xla-csr-segsum-spmm", "CSR", "xla",
                          "multi-vector extension (no reference analog)",
                          prepare=_prep_xla_segsum_spmm, spmm=True,
                          spmm_only=True))
    register(StrategySpec("xla-dense", "DENSE", "xla",
                          "tiny-matrix regime (SURVEY.md section 6)",
                          prepare=_prep_xla_dense))

    def _prep_omp(A: CSR, kind: str, nthreads: int = 0, **_):
        from spmv_scpa_tpu.formats.ell import csr_to_ell
        from spmv_scpa_tpu.ops import native_omp
        if not native_omp.available():
            raise ValueError("native OpenMP library unavailable "
                             "(make and a C++ compiler required; see "
                             "native/)")
        nblocks = None
        if kind == "guided":
            fn = native_omp.make_csr_omp_guided(A, nthreads)
        elif kind == "nnz":
            fn = native_omp.make_csr_omp_nnz(A, nthreads or 1)
        else:
            E = csr_to_ell(A, slice_h=32, col_major=True,
                           pad_mode="last")
            fn = native_omp.make_ell_omp(E, nthreads)
            nblocks = E.num_slices
        return Prepared(f"omp-csr-{kind}" if kind != "ell" else "omp-ell",
                        A.name, fn, on_device=False, nnz=A.nnz,
                        hbm_bytes=A.nnz * 12,
                        meta={"num_blocks": nblocks,
                              "num_threads": nthreads})

    register(StrategySpec("omp-csr-guided", "CSR", "host",
                          "csr_spmv_omp_guided csr.c:278-298 "
                          "(native/spmv_omp.cpp)",
                          prepare=lambda A, **kw: _prep_omp(A, "guided",
                                                            **kw)))
    register(StrategySpec("omp-csr-nnz", "CSR", "host",
                          "csr_spmv_omp_nnz_balancing csr.c:218-339 "
                          "(native/spmv_omp.cpp)",
                          prepare=lambda A, **kw: _prep_omp(A, "nnz",
                                                            **kw)))
    register(StrategySpec("omp-ell", "HLL", "host",
                          "hll_spmv_omp hll.c:178-211 "
                          "(native/spmv_omp.cpp)",
                          prepare=lambda A, **kw: _prep_omp(A, "ell",
                                                            **kw)))

    def _prep_hell(A: CSR, interpret: bool = False, **_):
        E = hell.plan_hell(A)
        raw, args = hell.make_hell(E, A.m, interpret=interpret)
        return Prepared("pallas-hell", A.name, bind(raw, args),
                        on_device=True, nnz=A.nnz, raw=raw, args=args,
                        hbm_bytes=E.padded_nnz * 8 + E.num_slices * 8,
                        meta={"num_blocks": E.num_slices, "fill": E.fill,
                              "num_warps": hell.NUM_WARPS})

    register(StrategySpec("pallas-hell", "HLL", "pallas",
                          "cuda_hll.cu:49-72 (k1 thread-per-row, "
                          "col-major, per-slice widths)",
                          prepare=_prep_hell))
