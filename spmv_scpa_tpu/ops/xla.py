"""XLA-native SpMV/SpMM paths (no Pallas): gather + segment reduce.

All ``make_*`` functions return ``(raw, args)``: a raw traceable
function ``raw(x, *args)`` plus the tuple of device-resident matrix
arrays. Arrays are passed as jit *arguments*, never closed over —
closed-over device arrays get baked into the compiled program as
constants (gigabytes re-shipped per compile). The registry jits and
binds them; the bench layer embeds ``raw`` in timing loops
(bench/timing.py).

These are the always-correct baselines of the strategy axis, the
analogs of the reference's straightforward kernels:

* ``csr_segsum`` — per-nonzero gather ``x[JA]`` then row segment-sum;
  the analog of thread-per-row CUDA k0 (cuda_csr.cu:19-31) / the OpenMP
  guided loop (csr.c:286-293): XLA parallelizes the flat nnz stream and
  dynamically balances it, like ``schedule(guided)``.
* ``ell_uniform`` — dense gather-multiply-reduce over lane-padded ELL
  arrays, row-major or column-major; the analog of the HLL CUDA kernels
  (cuda_hll.cu:19-72). Padded slots hold in-bounds dummy columns with
  0.0 values (cuda_hll.cu:176-195), so no masking is needed.

Benchmark timing measures only the kernel, mirroring the reference's
kernel-only cudaEvent timing (cuda_csr.cu:224-226).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from spmv_scpa_tpu.formats.csr import CSR
from spmv_scpa_tpu.formats.ell import UniformEll


def _put(a, dtype=None):
    return jax.device_put(jnp.asarray(a, dtype=dtype))


# ---------------------------------------------------------------------------
# CSR segment-sum
# ---------------------------------------------------------------------------

def make_csr_segsum(A: CSR, dtype=jnp.float32):
    """``A @ x`` via gather + segment_sum. Segment ids are sorted
    (CSR row order)."""
    args = (_put(A.ja, jnp.int32), _put(A.as_, dtype),
            _put(A.row_ids(), jnp.int32))
    m = A.m

    def raw(x, ja, as_, rows):
        prod = as_ * jnp.take(x.astype(as_.dtype), ja)
        return jax.ops.segment_sum(prod, rows, num_segments=m,
                                   indices_are_sorted=True)

    return raw, args


def make_csr_segsum_spmm(A: CSR, dtype=jnp.float32):
    """SpMM variant: ``raw(X[n, c], *args) -> Y[m, c]``."""
    args = (_put(A.ja, jnp.int32), _put(A.as_, dtype),
            _put(A.row_ids(), jnp.int32))
    m = A.m

    def raw(X, ja, as_, rows):
        prod = as_[:, None] * jnp.take(X.astype(as_.dtype), ja, axis=0)
        return jax.ops.segment_sum(prod, rows, num_segments=m,
                                   indices_are_sorted=True)

    return raw, args


# ---------------------------------------------------------------------------
# Uniform ELL (dense gather)
# ---------------------------------------------------------------------------

def make_ell_uniform(E: UniformEll, dtype=jnp.float32):
    """Return a jitted ``fn(x) -> y`` over the statically-padded ELL
    arrays. Works for both layouts; the reduction runs over the slot
    axis (axis 2 row-major, axis 1 col-major — hll.c:84-88)."""
    args = (_put(E.ja, jnp.int32), _put(E.as_, dtype))
    m = E.m
    slot_axis = 1 if E.col_major else 2

    def raw(x, ja, as_):
        xv = jnp.take(x.astype(as_.dtype), ja)       # (ns, ·, ·)
        y = jnp.sum(as_ * xv, axis=slot_axis)        # (ns, slice_h)
        return y.reshape(-1)[:m]

    return raw, args


def make_ell_uniform_spmm(E: UniformEll, dtype=jnp.float32):
    args = (_put(E.ja, jnp.int32), _put(E.as_, dtype))
    m, slot_axis = E.m, (1 if E.col_major else 2)

    def raw(X, ja, as_):
        xv = jnp.take(X.astype(as_.dtype), ja, axis=0)   # (ns, ·, ·, c)
        y = jnp.sum(as_[..., None] * xv, axis=slot_axis)
        return y.reshape(-1, X.shape[1])[:m]

    return raw, args


# ---------------------------------------------------------------------------
# Dense fallback (tiny matrices / debugging)
# ---------------------------------------------------------------------------

def make_dense(A: CSR, dtype=jnp.float32):
    """Materialize A densely and matmul — only sensible for tiny
    matrices (the launch-bound regime where the reference's GPU kernels
    drop to ~0-2 GFLOPS, SURVEY.md section 6)."""
    args = (_put(A.to_dense(), dtype),)

    def raw(x, Ad):
        # HIGHEST: an f32 product may otherwise run in TF32 (~1e-3)
        return jnp.matmul(Ad, x.astype(Ad.dtype),
                          precision=jax.lax.Precision.HIGHEST)

    return raw, args


# ---------------------------------------------------------------------------
# Host "serial" kernels (golden-adjacent, used for serial.csv parity)
# ---------------------------------------------------------------------------

def serial_csr(A: CSR, x: np.ndarray) -> np.ndarray:
    """Host fp64 CSR SpMV — identical math to the oracle; exists so the
    serial benchmark path mirrors bench_csr_serial (csr.c:342-353)."""
    from spmv_scpa_tpu.ops.oracle import spmv_oracle
    return spmv_oracle(A, x)


def serial_ell(E, x: np.ndarray) -> np.ndarray:
    """Host fp64 HLL-analog serial SpMV (reference: hll_spmv_serial,
    hll.c:127-150): per-slice padded gather-multiply in NumPy."""
    x = np.asarray(x, dtype=np.float64)
    y = np.zeros(E.m, dtype=np.float64)
    for s in range(E.num_slices):
        ja, as_ = E.block(s)
        if E.col_major:
            ja, as_ = ja.T, as_.T
        safe = np.maximum(ja, 0)
        vals = as_ * x[safe]
        if E.pad_mode == "neg1":
            vals = np.where(ja >= 0, vals, 0.0)
        r0 = s * E.slice_h
        y[r0:r0 + ja.shape[0]] = vals.sum(axis=1)
    return y


# ---------------------------------------------------------------------------
# df64 (double-float) ELL — fp64-grade accumulation on f32 hardware
# ---------------------------------------------------------------------------

def make_ell_df64(E: UniformEll):
    """fp64-equivalent SpMV in f32 via double-float arithmetic
    (ops/df64.py): matrix values and x are carried as (hi, lo) f32
    pairs, products use error-free transformations, and the slot
    reduction is a compensated loop. Matches the fp64 oracle to
    ~1e-12 relative — far inside the reference's 1e-1 epsilon
    (utils.c:53); this is the BASELINE.json "fp64 tolerance" knob.

    Input protocol: ``prep_x`` packs the host f64 x into a stacked
    (2, n) f32 hi/lo array, so the path needs no device f64.
    """
    import numpy as np

    from spmv_scpa_tpu.ops import df64

    as64 = E.as_
    as_hi = as64.astype(np.float32)
    as_lo = (as64 - as_hi.astype(np.float64)).astype(np.float32)
    # move the slot axis first for the reduction loop
    slot_axis = 1 if E.col_major else 2
    ja_k = np.moveaxis(E.ja, slot_axis, 0)
    args = (_put(np.ascontiguousarray(ja_k), jnp.int32),
            _put(np.ascontiguousarray(np.moveaxis(as_hi, slot_axis, 0))),
            _put(np.ascontiguousarray(np.moveaxis(as_lo, slot_axis, 0))))
    m, k = E.m, int(ja_k.shape[0])

    def prep_x(x):
        x = np.asarray(x, np.float64)
        hi = x.astype(np.float32)
        lo = (x - hi.astype(np.float64)).astype(np.float32)
        return jax.device_put(jnp.stack([hi, lo]))

    def raw(x2, ja, ah, al):
        xh, xl = x2[0], x2[1]

        def body(i, acc):
            j = jax.lax.dynamic_index_in_dim(ja, i, keepdims=False)
            a_h = jax.lax.dynamic_index_in_dim(ah, i, keepdims=False)
            a_l = jax.lax.dynamic_index_in_dim(al, i, keepdims=False)
            v_h = jnp.take(xh, j)
            v_l = jnp.take(xl, j)
            p, e = df64.two_prod(a_h, v_h)
            e = e + a_h * v_l + a_l * v_h + a_l * v_l
            return df64.df64_add(acc, (p, e))

        shape = ja.shape[1:]
        y = jax.lax.fori_loop(
            0, k, body, (jnp.zeros(shape), jnp.zeros(shape)))
        return jnp.stack([y[0].reshape(-1)[:m], y[1].reshape(-1)[:m]])

    def post(y2):
        y2 = np.asarray(y2, np.float64)
        return y2[0] + y2[1]

    return raw, args, prep_x, post
