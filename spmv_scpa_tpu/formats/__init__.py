from spmv_scpa_tpu.formats.csr import CSR
from spmv_scpa_tpu.formats.ell import EllSlices

__all__ = ["CSR", "EllSlices"]
