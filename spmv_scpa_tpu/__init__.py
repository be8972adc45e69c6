"""spmv_scpa_tpu — a sparse matrix-vector multiplication framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
``0xmenna/spmv-scpa`` C/OpenMP/CUDA reference study, running on an
NVIDIA GPU:

* Matrix Market loader with symmetric/pattern expansion
  (reference: ``src/mmio.c``, ``src/csr.c:31-171``),
* CSR and HLL (hacked-ELLPACK slice) formats (reference:
  ``include/csr.h``, ``include/hll.h``),
* a family of SpMV kernel strategies (XLA gather + segment-sum and ELL
  paths, and the per-slice-padded HLL kernel through Pallas/Triton)
  mirroring the reference's serial / OpenMP / CUDA strategy axis
  (``src/csr.c``, ``src/hll.c``, ``src/cuda_csr.cu``,
  ``src/cuda_hll.cu``),
* fp64-tolerance validation against a serial golden oracle
  (reference: ``src/utils.c:39-60``),
* a benchmark harness reproducing the reference's CSV output
  (``src/logger.c``), batch runner (``scripts/results.py``) and plots
  (``scripts/plots.py``),
* multi-vector SpMM and row-sharded distributed SpMV over several GPUs
  via ``shard_map`` (no analog in the reference, which is
  single-process; see SURVEY.md section 2 rows marked ABSENT-IN-REF).

The compute path is pure JAX (XLA + Pallas); host-side preprocessing is
NumPy with an optional native C++ Matrix Market parser (``native/``).
"""

from spmv_scpa_tpu.formats.csr import CSR
from spmv_scpa_tpu.formats.ell import EllSlices
from spmv_scpa_tpu.io.loader import load_csr
from spmv_scpa_tpu.ops.oracle import spmv_oracle
from spmv_scpa_tpu.ops.registry import (
    get_strategy,
    list_strategies,
    spmv,
)

__version__ = "0.1.0"

__all__ = [
    "CSR",
    "EllSlices",
    "load_csr",
    "spmv_oracle",
    "spmv",
    "get_strategy",
    "list_strategies",
    "__version__",
]
