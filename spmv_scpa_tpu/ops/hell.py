"""``pallas-hell``: hacked-ELLPACK SpMV for the GPU through Pallas' Triton
route.

Reference design: the winning HLL kernel of the CUDA study, k1
thread-per-row over a column-major slice (cuda_hll.cu:49-72). The matrix
is cut into slices of ``SLICE_H`` rows; each slice is padded only to its
own longest row (hll.c:19-95) and stored column-major, so the
``SLICE_H`` threads of a slice read consecutive ``ja``/``as`` words at
every slot. Padded slots hold an in-bounds column and 0.0
(cuda_hll.cu:176-195), so no row needs a mask.

One Triton program handles one slice: it loads that slice's flat offset
and width itself, loops over the width with ``fori_loop`` (a dynamic
trip count), gathers ``x[ja]`` through L1/L2 (the k4 texture-x idea,
cuda_csr.cu:145-178), accumulates in f32 registers and writes its
``SLICE_H`` entries of y directly, one slot per iteration. Plain XLA
can express this layout only by padding every slice to the global
longest row (``xla-ell-cm``), which refuses power-law matrices; this
kernel keeps per-slice widths.

``interpret=True`` runs the same kernel in the Pallas interpreter (the
CPU tests); there is no implicit fallback to it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from spmv_scpa_tpu.formats.csr import CSR
from spmv_scpa_tpu.formats.ell import EllSlices, csr_to_ell

# Slice height, warps and stages of the kernel: 32-row slices (one warp
# of threads, as in the reference), one warp, one stage. A sweep over
# heights 32-128, 1-8 warps and 1 or 3 stages on an H100 found all
# within 20% and this the best; see PERF.md.
SLICE_H = 32
NUM_WARPS = 1
NUM_STAGES = 1
# Least slot fill (nonzeros over padded slots) the plan accepts, and
# at which pick_auto sends a GPU matrix here. Measured on an H100: at
# fill 0.25 (amazon archetype) this kernel took 22 us against 59 us
# for xla-csr-segsum; at 0.06 (webbase) the two tied; at 0.04
# (powerlaw) segment-sum was twice as fast.
MIN_FILL = 0.1


def slice_widths(A: CSR) -> np.ndarray:
    """Per-slice longest row (at least 1 slot), slices of ``SLICE_H``
    rows with the last one padded by empty rows."""
    ns = max(1, -(-A.m // SLICE_H))
    lens = np.zeros(ns * SLICE_H, np.int64)
    lens[:A.m] = A.row_lengths()
    return np.maximum(lens.reshape(ns, SLICE_H).max(axis=1), 1)


def hell_fill(A: CSR) -> float:
    """Fraction of the padded slots that hold a real nonzero: what
    ``pick_auto`` reads to choose this kernel without building it."""
    return A.nnz / float(slice_widths(A).sum() * SLICE_H)


def hell_layout(A: CSR) -> EllSlices:
    """Column-major HLL of ``A`` with every slice ``SLICE_H`` rows tall
    (the matrix is padded with empty rows to a whole number of slices,
    so the kernel needs no row mask), whatever its fill."""
    if A.m == 0:
        raise ValueError("pallas-hell: matrix has no rows")
    m_pad = -(-A.m // SLICE_H) * SLICE_H
    irp = np.concatenate([A.irp, np.full(m_pad - A.m, A.irp[-1],
                                         A.irp.dtype)])
    Ap = CSR(A.name, m_pad, A.n, irp, A.ja, A.as_)
    E = csr_to_ell(Ap, slice_h=SLICE_H, col_major=True, pad_mode="last")
    if E.padded_nnz >= 2**31:
        raise ValueError("pallas-hell: padded slots exceed int32 offsets")
    return E


def plan_hell(A: CSR) -> EllSlices:
    """:func:`hell_layout` of ``A``; raises ``ValueError`` when the
    fill is below ``MIN_FILL`` (rows too uneven within slices, so the
    kernel would stream mostly padding)."""
    fill = hell_fill(A)
    if A.nnz and fill < MIN_FILL:
        raise ValueError(f"pallas-hell: fill {fill:.3f} below {MIN_FILL} "
                         "(rows too uneven within slices)")
    return hell_layout(A)


def _hell_kernel(offs_ref, width_ref, ja_ref, as_ref, x_ref, y_ref, *,
                 slice_h: int):
    s = pl.program_id(0)
    base = offs_ref[s]
    lane = jax.lax.iota(jnp.int32, slice_h)

    def body(j, acc):
        idx = base + j * slice_h + lane
        return acc + as_ref[idx] * x_ref[ja_ref[idx]]

    y_ref[...] = jax.lax.fori_loop(0, width_ref[s], body,
                                   jnp.zeros((slice_h,), jnp.float32))


def make_hell(E: EllSlices, m: int, *, interpret: bool = False):
    """``(raw, args)`` for the kernel over plan ``E`` (from
    :func:`plan_hell` or :func:`hell_layout`); ``raw(x, *args)``
    returns y of length ``m``."""
    ns, h = E.num_slices, E.slice_h
    # y is exactly m long: the last block's stores past m are masked,
    # which saves the copy a padded y would need to be sliced
    args = (jax.device_put(jnp.asarray(E.offs[:-1], jnp.int32)),
            jax.device_put(jnp.asarray(E.max_nz, jnp.int32)),
            jax.device_put(jnp.asarray(E.ja_flat, jnp.int32)),
            jax.device_put(jnp.asarray(E.as_flat, jnp.float32)))
    call = pl.pallas_call(
        functools.partial(_hell_kernel, slice_h=h),
        out_shape=jax.ShapeDtypeStruct((m,), jnp.float32),
        grid=(ns,),
        out_specs=pl.BlockSpec((h,), lambda s: (s,)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="hell_spmv",
    )

    def raw(x, offs, width, ja, as_):
        return call(offs, width, ja, as_, x.astype(jnp.float32))

    return raw, args
