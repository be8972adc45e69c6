"""ctypes bindings to the native OpenMP SpMV kernels
(native/spmv_omp.cpp) — the host-parallel backend.

The reference's OpenMP strategy family (csr.c:218-339, hll.c:178-211)
lives here as real C++/OpenMP code swept over thread counts
(main.c:177-180), not an XLA stand-in. Built (or rebuilt when its
source is newer) on first use. Where the compiler has no OpenMP the
library is built single-threaded and reports it (:func:`openmp`); the
kernel builders then refuse thread counts above 1, so no row is ever
labelled with threads it did not run on.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from spmv_scpa_tpu.formats.csr import CSR, partition_rows_by_nnz

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libspmvomp.so")

_lib = None
_tried = False

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F64P = ctypes.POINTER(ctypes.c_double)


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:                        # a no-op when the library is up to date
        subprocess.run(["make", "-C", _NATIVE_DIR, "-s", "libspmvomp.so"],
                       check=True, capture_output=True, timeout=120)
    except Exception:
        if not os.path.exists(_LIB_PATH):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.spmv_csr_serial.argtypes = [ctypes.c_int64, _I64P, _I32P, _F64P,
                                    _F64P, _F64P]
    lib.spmv_csr_omp_guided.argtypes = lib.spmv_csr_serial.argtypes + [
        ctypes.c_int]
    lib.spmv_csr_omp_nnz.argtypes = lib.spmv_csr_serial.argtypes + [
        _I64P, ctypes.c_int]
    lib.spmv_ell_omp.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _I64P, _I32P,
        _I32P, _F64P, _F64P, _F64P, ctypes.c_int]
    lib.omp_max_threads.restype = ctypes.c_int
    lib.spmv_built_with_openmp.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def max_threads() -> int:
    lib = _load()
    return int(lib.omp_max_threads()) if lib else 1


def openmp() -> bool:
    """Whether the loaded library was compiled with OpenMP."""
    lib = _load()
    return bool(lib and lib.spmv_built_with_openmp())


def _check_threads(nthreads: int):
    if nthreads > 1 and not openmp():
        raise ValueError(f"libspmvomp.so was built without OpenMP: "
                         f"{nthreads} threads would run on one")


def _csr_bufs(A: CSR):
    irp = np.ascontiguousarray(A.irp, dtype=np.int64)
    ja = np.ascontiguousarray(A.ja, dtype=np.int32)
    as_ = np.ascontiguousarray(A.as_, dtype=np.float64)
    return irp, ja, as_


def make_csr_serial(A: CSR):
    lib = _load()
    irp, ja, as_ = _csr_bufs(A)

    def fn(x):
        x = np.ascontiguousarray(x, dtype=np.float64)
        y = np.empty(A.m, dtype=np.float64)
        lib.spmv_csr_serial(A.m, irp.ctypes.data_as(_I64P),
                            ja.ctypes.data_as(_I32P),
                            as_.ctypes.data_as(_F64P),
                            x.ctypes.data_as(_F64P),
                            y.ctypes.data_as(_F64P))
        return y

    return fn


def make_csr_omp_guided(A: CSR, nthreads: int = 0):
    _check_threads(nthreads)
    lib = _load()
    irp, ja, as_ = _csr_bufs(A)

    def fn(x):
        x = np.ascontiguousarray(x, dtype=np.float64)
        y = np.empty(A.m, dtype=np.float64)
        lib.spmv_csr_omp_guided(A.m, irp.ctypes.data_as(_I64P),
                                ja.ctypes.data_as(_I32P),
                                as_.ctypes.data_as(_F64P),
                                x.ctypes.data_as(_F64P),
                                y.ctypes.data_as(_F64P), nthreads)
        return y

    return fn


def make_csr_omp_nnz(A: CSR, nthreads: int):
    """Static nnz-balanced spans (csr.c:218-276 planner + 305-339
    kernel); the Python partitioner plans, C++ executes."""
    _check_threads(nthreads)
    lib = _load()
    irp, ja, as_ = _csr_bufs(A)
    bounds = np.ascontiguousarray(
        partition_rows_by_nnz(A.irp, max(nthreads, 1)), dtype=np.int64)
    nparts = bounds.shape[0] - 1

    def fn(x):
        x = np.ascontiguousarray(x, dtype=np.float64)
        y = np.empty(A.m, dtype=np.float64)
        lib.spmv_csr_omp_nnz(A.m, irp.ctypes.data_as(_I64P),
                             ja.ctypes.data_as(_I32P),
                             as_.ctypes.data_as(_F64P),
                             x.ctypes.data_as(_F64P),
                             y.ctypes.data_as(_F64P),
                             bounds.ctypes.data_as(_I64P), nparts)
        return y

    return fn


def make_ell_omp(E, nthreads: int = 0):
    """ELL-slice OpenMP kernel (hll.c:178-211); ``E`` is a
    formats.ell.EllSlices, col-major layout with pad_mode='last'
    (branch-free dummy reads, cuda_hll.cu:176-195)."""
    assert E.col_major and E.pad_mode == "last", \
        "spmv_ell_omp needs col-major 'last'-padded slices"
    _check_threads(nthreads)
    lib = _load()
    offsets = np.ascontiguousarray(E.offs, dtype=np.int64)
    widths = np.ascontiguousarray(E.max_nz, dtype=np.int32)
    ja = np.ascontiguousarray(E.ja_flat, dtype=np.int32)
    as_ = np.ascontiguousarray(E.as_flat, dtype=np.float64)

    def fn(x):
        x = np.ascontiguousarray(x, dtype=np.float64)
        y = np.zeros(E.m, dtype=np.float64)
        lib.spmv_ell_omp(E.m, E.slice_h, E.num_slices,
                         offsets.ctypes.data_as(_I64P),
                         widths.ctypes.data_as(_I32P),
                         ja.ctypes.data_as(_I32P),
                         as_.ctypes.data_as(_F64P),
                         x.ctypes.data_as(_F64P),
                         y.ctypes.data_as(_F64P), nthreads)
        return y

    return fn
