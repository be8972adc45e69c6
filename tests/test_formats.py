"""Format conversion tests: every layout must reproduce the dense matrix
(the CSR→HLL→dense roundtrip property from SURVEY.md section 4)."""

import numpy as np
import pytest

from spmv_scpa_tpu.formats.csr import CSR, partition_rows_by_nnz
from spmv_scpa_tpu.formats.ell import csr_to_ell
from spmv_scpa_tpu import testing as synth


def test_csr_from_coo_roundtrip():
    dense = np.array([[0., 2., 0.], [1., 0., 0.], [0., 0., 0.]])
    A = CSR.from_dense("d", dense)
    np.testing.assert_allclose(A.to_dense(), dense)
    assert A.nnz == 2
    assert A.irp.tolist() == [0, 1, 2, 2]


def test_csr_duplicates_kept_and_summed_views():
    # reference keeps duplicates (two-pass fill, csr.c:115-146);
    # to_dense accumulates them, from_coo(sum_duplicates=True) merges.
    A = CSR.from_coo("dup", 2, 2, [0, 0], [1, 1], [2.0, 3.0])
    assert A.nnz == 2
    np.testing.assert_allclose(A.to_dense(), [[0, 5], [0, 0]])
    B = CSR.from_coo("dup", 2, 2, [0, 0], [1, 1], [2.0, 3.0],
                     sum_duplicates=True)
    assert B.nnz == 1
    np.testing.assert_allclose(B.to_dense(), [[0, 5], [0, 0]])


def test_csr_slice_rows():
    A = synth.banded_csr(64, row_nnz=5, bandwidth=16, seed=7)
    S = A.slice_rows(16, 48)
    np.testing.assert_allclose(S.to_dense(), A.to_dense()[16:48])


@pytest.mark.parametrize("col_major", [False, True])
@pytest.mark.parametrize("pad_mode", ["last", "neg1"])
@pytest.mark.parametrize("slice_h", [8, 32])
def test_ell_roundtrip(matrices, col_major, pad_mode, slice_h):
    for A in matrices:
        E = csr_to_ell(A, slice_h=slice_h, col_major=col_major,
                       pad_mode=pad_mode)
        np.testing.assert_allclose(E.to_dense(), A.to_dense(),
                                   err_msg=A.name)
        assert E.nnz == A.nnz
        # per-slice padding: max_nz matches longest row in slice
        lens = A.row_lengths()
        for s in range(E.num_slices):
            r0, r1 = s * slice_h, min((s + 1) * slice_h, A.m)
            assert E.max_nz[s] == max(1, int(lens[r0:r1].max(initial=0)))


@pytest.mark.parametrize("col_major", [False, True])
def test_ell_uniform_roundtrip(matrices, col_major):
    for A in matrices:
        U = csr_to_ell(A, col_major=col_major).to_uniform()
        # reconstruct dense from uniform arrays
        ja, as_ = U.ja, U.as_
        if col_major:
            ja = ja.transpose(0, 2, 1)
            as_ = as_.transpose(0, 2, 1)
        dense = np.zeros((U.num_slices * U.slice_h, A.n))
        rows = np.arange(U.num_slices * U.slice_h).reshape(
            U.num_slices, U.slice_h)
        np.add.at(dense, (np.broadcast_to(rows[..., None], ja.shape), ja), as_)
        np.testing.assert_allclose(dense[:A.m], A.to_dense(), err_msg=A.name)
        # all padded indices are in-bounds
        assert ja.min() >= 0 and ja.max() < max(A.n, 1)


def test_partition_rows_by_nnz():
    # reference planner: csr.c:218-276 — ≈nnz/parts nonzeros per span
    A = synth.powerlaw_csr(500, 500, seed=9)
    for parts in (1, 3, 8, 40):
        b = partition_rows_by_nnz(A.irp, parts)
        assert b[0] == 0 and b[-1] == A.m and len(b) == parts + 1
        assert (np.diff(b) >= 0).all()
        nnz_per = np.diff(A.irp[b].astype(np.int64))
        assert nnz_per.sum() == A.nnz
        # balance: no span more than ~2x ideal + one max row
        ideal = A.nnz / parts
        max_row = int(A.row_lengths().max())
        assert nnz_per.max() <= 2 * ideal + max_row


