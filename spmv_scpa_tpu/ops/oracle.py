"""Golden serial oracle — the correctness anchor for every kernel.

The reference's golden result is the serial CSR kernel in fp64
(``csr_spmv_serial``, src/csr.c:201-216, captured once in debug mode at
main.c:140-146). Ours is the same classic row loop, vectorized in
NumPy float64 on the host — deliberately *not* JAX, so the oracle is
independent of the device stack it validates.
"""

from __future__ import annotations

import numpy as np

from spmv_scpa_tpu.formats.csr import CSR


def spmv_oracle(A: CSR, x: np.ndarray) -> np.ndarray:
    """y = A @ x in float64 (reference: csr.c:205-212)."""
    x = np.asarray(x, dtype=np.float64)
    if x.shape[0] != A.n:
        raise ValueError(f"x has length {x.shape[0]}, expected {A.n}")
    return _row_sums(A, A.as_ * x[A.ja])


def spmm_oracle(A: CSR, X: np.ndarray) -> np.ndarray:
    """Y = A @ X for multi-column X (the SpMM extension; no reference
    analog — the reference is single-vector only)."""
    X = np.asarray(X, dtype=np.float64)
    if X.ndim == 1:
        return spmv_oracle(A, X)
    if X.shape[0] != A.n:
        raise ValueError(f"X has {X.shape[0]} rows, expected {A.n}")
    return _row_sums(A, A.as_[:, None] * X[A.ja])


def _row_sums(A: CSR, prod: np.ndarray) -> np.ndarray:
    """Per-row sums of the per-nonzero products, in row order. Each
    non-empty row is one contiguous run starting at ``irp[r]`` (empty
    rows in between start where the run ends), so ``reduceat`` over the
    non-empty rows' starts sums exactly their entries."""
    y = np.zeros((A.m,) + prod.shape[1:], dtype=np.float64)
    nonempty = np.diff(A.irp) > 0
    if prod.shape[0]:
        y[nonempty] = np.add.reduceat(prod, A.irp[:-1][nonempty], axis=0)
    return y
