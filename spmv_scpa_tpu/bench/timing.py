"""Kernel timing + GFLOPS accounting.

Reference semantics to reproduce (SURVEY.md section 5, "tracing"):

* GFLOPS = 2*nnz / (duration_ms * 1e6) — utils.h:70-75;
* device timing measures the kernel only, not host<->device transfers
  (cudaEvent pair around the bare launch, cuda_csr.cu:224-226).

Device strategies run K times inside one jitted ``lax.fori_loop``
whose trip count is a *runtime* scalar (one compile per strategy), with
a tiny data dependency between iterations so XLA cannot hoist or CSE
the body, and two trip counts are differenced:

    per_call = (wall(K) - wall(K0)) / (K - K0)

which cancels dispatch and synchronization overhead. Each iteration
re-reads the same matrix, so a matrix that fits the GPU's L2 is timed
warm.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np

log = logging.getLogger(__name__)


@dataclass
class BenchResult:
    """Analog of the reference's ``bench`` struct (utils.h:32-36)."""

    duration_ms: float
    gflops: float
    data: np.ndarray | None = None        # result vector y
    reps: int = 1
    all_ms: list = field(default_factory=list)
    # True when the two-point measurement stayed degenerate after a
    # retry (noisy host) — duration_ms is then a clamped lower bound.
    suspect: bool = False


def compute_gflops(nnz: int, duration_ms: float, ncols: int = 1) -> float:
    """2*nnz flops per matvec column (utils.h:70-75)."""
    if duration_ms <= 0:
        return 0.0
    return 2.0 * nnz * ncols / (duration_ms * 1e6)


def time_host_fn(fn, x, *, nnz: int, reps: int = 10,
                 max_time_s: float = 5.0) -> BenchResult:
    """Time a host (NumPy) kernel directly — the serial path
    (bench_csr_serial analog, csr.c:342-353)."""
    y = fn(x)
    times = []
    elapsed = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        y = fn(x)
        dt = time.perf_counter() - t0
        times.append(dt * 1e3)
        elapsed += dt
        if elapsed > max_time_s:
            break
    ms = float(np.median(times))
    ncols = 1 if np.ndim(y) <= 1 else np.shape(y)[-1]
    return BenchResult(ms, compute_gflops(nnz, ms, ncols),
                       data=np.asarray(y, np.float64),
                       reps=len(times), all_ms=times)


def _make_looped(raw_fn):
    """jitted (x, k, *args) -> 1-element slice of x', running
    raw_fn(x, *args) k times with an un-CSE-able serial dependency."""
    import jax

    @jax.jit
    def run(x, k, *args):
        def body(i, c):
            y = raw_fn(c, *args)
            bump = (y.ravel()[0] * 1e-30).astype(c.dtype)
            return c + bump
        xf = jax.lax.fori_loop(0, k, body, x)
        return xf.ravel()[:1]

    return run


def _sync_run(run, x_d, k, args) -> float:
    """Wall seconds for k loop iterations, ended by a readback."""
    t0 = time.perf_counter()
    np.asarray(run(x_d, k, *args))
    return time.perf_counter() - t0


def time_device_fn(raw_fn, x, *, args: tuple = (), nnz: int, ncols: int = 1,
                   target_s: float = 0.4, k0: int = 2,
                   max_k: int = 4096, prep_x=None, post=None) -> BenchResult:
    """Amortized device timing of ``raw_fn(x, *args)`` (traceable,
    unjitted; args are device-resident matrix arrays).

    Returns kernel-only per-call time (overhead cancelled by the
    two-point difference). The result vector is computed once more via
    a direct call for validation.
    """
    import jax
    import jax.numpy as jnp

    x_d = prep_x(x) if prep_x else jax.device_put(jnp.asarray(x))
    run = _make_looped(raw_fn)
    _sync_run(run, x_d, 1, args)                     # compile + warm
    w0 = _sync_run(run, x_d, k0, args)

    # grow K until the loop dominates overhead
    k = max(4 * k0, 8)
    while True:
        w = _sync_run(run, x_d, k, args)
        if w > target_s or k >= max_k:
            break
        # estimate per-iter to pick the final K in one jump
        per = max((w - w0) / max(k - k0, 1), 1e-7)
        k_next = int(min(max_k, max(k * 2, (target_s * 1.2) / per)))
        if k_next <= k:
            break
        k = k_next
    # Final two-point measurement. On a noisy host the difference can
    # come out non-positive (the k//4 run hit a scheduling hiccup); a
    # silent 1e-9 clamp would log an absurd GFLOPS row, so re-measure
    # once and, if still degenerate, mark the row suspect instead of
    # lying (the reference's cudaEvent window is immune to host noise
    # by construction, cuda_timer.cu:11-21).
    suspect = False
    k_lo = max(k // 4, 1)
    for attempt in range(2):
        w_hi = _sync_run(run, x_d, k, args)
        w_lo = _sync_run(run, x_d, k_lo, args)
        per_call = (w_hi - w_lo) / (k - k_lo)
        if per_call > 1e-9:
            break
        if attempt == 0:
            log.warning("non-positive two-point timing (w_hi=%.6f <= "
                        "w_lo=%.6f at k=%d/%d); re-measuring once",
                        w_hi, w_lo, k, k_lo)
    else:
        suspect = True
        log.warning("timing remains degenerate after retry; row marked "
                    "suspect (per_call clamped)")
    per_call = max(per_call, 1e-9)
    ms = per_call * 1e3

    y = jax.jit(raw_fn)(x_d, *args)
    y = np.asarray(post(y) if post else y, dtype=np.float64)
    return BenchResult(ms, compute_gflops(nnz, ms, ncols), data=y,
                       reps=k, all_ms=[w_lo * 1e3, w_hi * 1e3],
                       suspect=suspect)


def time_prepared(prep, x, **kw) -> BenchResult:
    """Dispatch on a registry ``Prepared``: device strategies get
    amortized loop timing, host strategies direct timing."""
    if prep.on_device and prep.raw is not None:
        ncols = 1 if np.ndim(x) <= 1 else np.shape(x)[-1]
        return time_device_fn(prep.raw, x, args=prep.args, nnz=prep.nnz,
                              ncols=ncols, prep_x=prep.prep_x,
                              post=prep.post, **kw)
    return time_host_fn(prep.fn, x, nnz=prep.nnz)
