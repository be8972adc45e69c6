"""pallas-hell: the slice plan on the host, and the Triton kernel in the
Pallas interpreter against the fp64 oracle (the compiled kernel runs
only on a GPU: see the ``gpu``-marked case)."""

import numpy as np
import pytest

from spmv_scpa_tpu import testing as synth
from spmv_scpa_tpu.formats.csr import CSR
from spmv_scpa_tpu.ops import hell
from spmv_scpa_tpu.ops.oracle import spmv_oracle
from spmv_scpa_tpu.ops.registry import get_strategy
from spmv_scpa_tpu.utils.validation import validate_result
from spmv_scpa_tpu.utils.vector import make_x


def _run(A, interpret=True):
    E = hell.hell_layout(A)
    raw, args = hell.make_hell(E, A.m, interpret=interpret)
    import jax
    return np.asarray(jax.jit(raw)(make_x(A.n), *args), np.float64)


@pytest.mark.parametrize("idx", range(7))
def test_hell_matches_oracle_on_zoo(matrices, idx):
    A = matrices[idx]
    validate_result(spmv_oracle(A, make_x(A.n)), _run(A), rtol=1e-5,
                    abs_l2=0.0, what=f"pallas-hell on {A.name}")


@pytest.mark.parametrize("m", [31, 32, 33, 95])
def test_hell_y_has_exact_length(m):
    """y is written at exactly m rows: the last slice's stores past m
    are masked, whether m is a multiple of the slice height or not."""
    A = synth.banded_csr(m, row_nnz=5, bandwidth=12, seed=m)
    got = _run(A)
    assert got.shape == (m,)
    validate_result(spmv_oracle(A, make_x(A.n)), got, rtol=1e-5,
                    abs_l2=0.0, what=f"m={m}")


def test_slice_widths_and_fill():
    # rows of length 0..4 in slices of 32: widths are per-slice maxima
    lens = np.array([3] * 32 + [0] * 31 + [5] + [1] * 10)
    irp = np.concatenate([[0], np.cumsum(lens)])
    A = CSR("w", lens.size, 8, irp, np.zeros(irp[-1], np.int32),
            np.ones(irp[-1]))
    np.testing.assert_array_equal(hell.slice_widths(A), [3, 5, 1])
    assert hell.hell_fill(A) == pytest.approx(lens.sum() / (9 * 32))


def test_plan_offsets_and_column_major_layout():
    A = synth.banded_csr(100, row_nnz=6, bandwidth=20, seed=3)
    E = hell.plan_hell(A)
    assert E.num_slices == 4 and E.slice_h == hell.SLICE_H == 32
    assert E.col_major
    np.testing.assert_array_equal(np.diff(E.offs), E.max_nz * 32)
    np.testing.assert_array_equal(E.max_nz, hell.slice_widths(A))
    # slot j of row r in slice s sits at offs[s] + j*32 + r
    lens = A.row_lengths()
    for r in (0, 37, 99):
        s, rr = divmod(r, 32)
        for j in range(lens[r]):
            assert E.ja_flat[E.offs[s] + j * 32 + rr] == A.ja[A.irp[r] + j]
    assert E.fill == pytest.approx(hell.hell_fill(A))


def test_plan_pads_last_slice_and_empty_rows():
    """m not a multiple of the slice: the plan pads with empty rows,
    whose slots read an in-bounds column with value 0."""
    dense = np.zeros((45, 9))
    dense[3, 4] = 2.0
    dense[40, 8] = -1.0
    A = CSR.from_dense("holes", dense)
    E = hell.hell_layout(A)
    assert E.m == 64 and E.num_slices == 2
    assert np.all((E.ja_flat >= 0) & (E.ja_flat < A.n))
    assert np.count_nonzero(E.as_flat) == 2
    got = _run(A)
    assert got.shape == (45,)
    validate_result(spmv_oracle(A, make_x(A.n)), got, rtol=1e-6,
                    abs_l2=0.0)


def test_plan_empty_matrix():
    A = CSR.from_coo("empty", 70, 5, [], [], [])
    E = hell.plan_hell(A)
    assert E.padded_nnz == 3 * 32 and not E.as_flat.any()
    assert np.all(_run(A) == 0.0)


def test_plan_refuses_a_matrix_without_rows():
    A = CSR.from_coo("norows", 0, 5, [], [], [])
    for plan in (hell.plan_hell, hell.hell_layout):
        with pytest.raises(ValueError, match="no rows"):
            plan(A)


def test_plan_refuses_low_fill():
    """One long row pads its whole slice to its length: the plan
    refuses below MIN_FILL instead of streaming mostly padding."""
    rows = np.concatenate([np.zeros(256, int), np.arange(1, 256)])
    cols = np.concatenate([np.arange(256), np.zeros(255, int)])
    A = CSR.from_coo("skew", 256, 256, rows, cols, np.ones(rows.size))
    assert hell.hell_fill(A) < hell.MIN_FILL
    with pytest.raises(ValueError, match="fill"):
        hell.plan_hell(A)
    with pytest.raises(ValueError, match="fill"):
        get_strategy("pallas-hell").prepare(A, interpret=True)
    # the layout alone still computes the product
    validate_result(spmv_oracle(A, make_x(A.n)), _run(A), rtol=1e-5,
                    abs_l2=0.0, what="low-fill layout")


def test_prepare_reports_bytes_and_geometry():
    A = synth.banded_csr(300, row_nnz=9, bandwidth=40, seed=1)
    prep = get_strategy("pallas-hell").prepare(A, interpret=True)
    E = hell.plan_hell(A)
    assert prep.hbm_bytes == E.padded_nnz * 8 + E.num_slices * 8
    assert prep.meta["num_blocks"] == E.num_slices
    assert prep.meta["num_warps"] == hell.NUM_WARPS == 1
    assert prep.meta["fill"] == pytest.approx(E.fill)


def test_kernel_names_the_triton_route():
    """The pallas_call names its backend, so no default route (Mosaic
    GPU in this JAX) is ever taken silently."""
    import jax
    A = synth.diag_csr(40)
    E = hell.plan_hell(A)
    raw, args = hell.make_hell(E, A.m, interpret=True)
    jaxpr = jax.make_jaxpr(raw)(np.ones(A.n, np.float32), *args)
    calls = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "pallas_call"]
    assert len(calls) == 1
    assert calls[0].params["backend"] == "triton"


@pytest.mark.gpu
def test_hell_compiled_on_gpu_matches_oracle(gpu):
    import jax
    A = synth.stencil_csr(20_000, points=6, run_len=12, bandwidth=500,
                          seed=3)
    with jax.default_device(gpu):
        got = _run(A, interpret=False)
    validate_result(spmv_oracle(A, make_x(A.n)), got, rtol=1e-5,
                    abs_l2=0.0, what="pallas-hell compiled")
