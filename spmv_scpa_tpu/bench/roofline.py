"""HBM-bandwidth roofline accounting.

SpMV is bandwidth-bound, so a kernel's speed-of-light time is

    t_min = bytes_streamed / bandwidth

where ``bytes_streamed`` counts the matrix layout bytes plus one pass
over x and y. The report gives it against two bandwidths: the card's
published peak (``PEAK_HBM_GBS``, keyed by ``device_kind``) and a plain
copy measured in the same process (``measure_copy_bw``), which is what
a streaming kernel can reach in practice. The reference implicitly ran
at its roofline too (~62 GFLOPS fp64 on a ~400 GB/s Turing part,
BASELINE.md), so roofline share is the hardware-neutral comparison.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

# Published HBM bandwidth, GB/s, by jax device_kind. Source: NVIDIA
# H100 Tensor Core GPU data sheet (H100 SXM5 80 GB: 3.35 TB/s).
PEAK_HBM_GBS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}

_COPY_BW: dict = {}


def peak_hbm_gbs(kind: str) -> float:
    """Published peak of ``kind``; an unknown device is an error, not a
    default."""
    try:
        return PEAK_HBM_GBS[kind]
    except KeyError:
        raise KeyError(f"no published HBM peak for device kind {kind!r}; "
                       f"known: {sorted(PEAK_HBM_GBS)}") from None


def measure_copy_bw(n_bytes: int = 1 << 30, reps: int = 20) -> float:
    """GB/s of a plain ``a + 1`` over ``n_bytes`` of f32 on the GPU
    (reads and writes ``n_bytes`` each), median of ``reps`` host-clock
    timings ended by ``block_until_ready``. Cached per process."""
    if "bw" in _COPY_BW:
        return _COPY_BW["bw"]
    import jax
    import jax.numpy as jnp

    from spmv_scpa_tpu.utils.platform import require_gpu
    require_gpu()
    a = jnp.ones((n_bytes // 4,), jnp.float32)
    f = jax.jit(lambda v: v + 1.0)
    f(a).block_until_ready()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        f(a).block_until_ready()
        times.append(time.perf_counter() - t0)
    _COPY_BW["bw"] = 2 * n_bytes / float(np.median(times)) / 1e9
    return _COPY_BW["bw"]


@dataclass
class RooflineReport:
    copy_bw_gbs: float
    peak_bw_gbs: float
    bytes_streamed: int
    t_min_ms: float          # at the measured copy bandwidth
    t_measured_ms: float
    fraction: float          # of the copy-bandwidth roofline
    fraction_peak: float     # of the published-peak roofline
    fraction_ideal: float    # format-free bytes at the copy bandwidth
    gflops: float


def ideal_bytes(nnz: int, m: int, x_bytes: int, y_bytes: int) -> int:
    """Format-free floor for f32 CSR: a 4 B value and a 4 B column per
    nonzero, 4 B row pointers, one pass over x and y."""
    return nnz * 8 + (m + 1) * 4 + x_bytes + y_bytes


def roofline(prep, duration_ms: float, gflops: float, *, m: int,
             x_bytes: int = 0, y_bytes: int = 0, copy_bw: float,
             peak_bw: float) -> RooflineReport:
    """Roofline report for a measured Prepared strategy run.

    ``fraction`` is against the kernel's ACTUAL streamed bytes
    (``prep.hbm_bytes``, how close it runs to the copy bandwidth on
    what it moves); ``fraction_ideal`` is against :func:`ideal_bytes`,
    so actual/ideal is the layout's padding overhead."""
    total = prep.hbm_bytes + x_bytes + y_bytes
    ideal = ideal_bytes(prep.nnz, m, x_bytes, y_bytes)

    def share(nbytes, bw):
        return nbytes / (bw * 1e9) * 1e3 / duration_ms if duration_ms > 0 \
            else 0.0

    return RooflineReport(
        copy_bw_gbs=copy_bw, peak_bw_gbs=peak_bw, bytes_streamed=total,
        t_min_ms=total / (copy_bw * 1e9) * 1e3, t_measured_ms=duration_ms,
        fraction=share(total, copy_bw), fraction_peak=share(total, peak_bw),
        fraction_ideal=share(ideal, copy_bw), gflops=gflops)
