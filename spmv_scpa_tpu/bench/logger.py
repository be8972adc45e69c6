"""CSV benchmark logger — schema-compatible with the reference.

The reference appends to three files under the out dir, writing the
header only when the file is new, flushing after every row
(src/logger.c:19-72). Schemas (logger.c:31-40):

* ``serial.csv``: matrix,format,rows,cols,nnz,num_blocks,duration_ms,gflops
* ``omp.csv``:    matrix,format,bench,rows,cols,nnz,num_blocks,num_threads,duration_ms,gflops
* ``cuda.csv``:   matrix,format,kernel,warps_per_block,rows,cols,nnz,num_blocks,duration_ms,gflops

We keep the filenames and columns byte-identical so the reference's
scripts/plots.py runs unmodified on our output. The ``cuda.csv``
columns map to: kernel = device-strategy id (see STRATEGY_IDS),
warps_per_block = the kernel's warp count (0 for XLA-compiled
strategies), the SpMM width for SpMM rows, the device count for
distributed rows. ``num_blocks`` is empty for CSR rows, as in the
reference (logger.c:92-96 prints an empty field).
"""

from __future__ import annotations

import os

# Stable numeric ids for device strategies (the cuda.csv `kernel`
# column; reference kernel ids are 0..4 CSR / 0..3 HLL, main.c:259-263).
STRATEGY_IDS = {
    "xla-csr-segsum": 0,
    "xla-ell-rm": 1,
    "xla-ell-cm": 2,
    "xla-dense": 3,
    "xla-ell-df64": 6,
    "xla-csr-segsum-spmm": 8,
    "distributed-rowshard": 9,
    "pallas-hell": 17,
}
# Ids 4, 5, 7 and 10-16 belonged to removed strategies; they are not
# reused, so old and new CSVs never collide.

_HEADERS = {
    "serial": "matrix,format,rows,cols,nnz,num_blocks,duration_ms,gflops",
    "omp": ("matrix,format,bench,rows,cols,nnz,num_blocks,"
            "num_threads,duration_ms,gflops"),
    "cuda": ("matrix,format,kernel,warps_per_block,rows,cols,nnz,"
             "num_blocks,duration_ms,gflops"),
}


class CsvLogger:
    """Append-mode CSV logger with lazy headers (logger.c:19-51).

    Append semantics double as crash-resume: an interrupted sweep keeps
    all completed rows (SURVEY.md section 5, checkpoint/resume row).
    """

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self._files = {}
        for kind, header in _HEADERS.items():
            path = os.path.join(out_dir, f"{kind}.csv")
            existed = os.path.exists(path) and os.path.getsize(path) > 0
            f = open(path, "a")
            if not existed:
                f.write(header + "\n")
                f.flush()
            self._files[kind] = f

    def close(self):
        for f in self._files.values():
            f.close()
        self._files = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @staticmethod
    def _blocks(num_blocks) -> str:
        return "" if num_blocks is None else str(int(num_blocks))

    def log_serial(self, *, matrix: str, fmt: str, rows: int, cols: int,
                   nnz: int, num_blocks, duration_ms: float, gflops: float):
        f = self._files["serial"]
        f.write(f"{matrix},{fmt},{rows},{cols},{nnz},"
                f"{self._blocks(num_blocks)},{duration_ms:f},{gflops:f}\n")
        f.flush()

    def log_omp(self, *, matrix: str, fmt: str, bench: str, rows: int,
                cols: int, nnz: int, num_blocks, num_threads: int,
                duration_ms: float, gflops: float):
        f = self._files["omp"]
        f.write(f"{matrix},{fmt},{bench},{rows},{cols},{nnz},"
                f"{self._blocks(num_blocks)},{num_threads},"
                f"{duration_ms:f},{gflops:f}\n")
        f.flush()

    def log_device(self, *, matrix: str, fmt: str, kernel,
                   warps_per_block: int,
                   rows: int, cols: int, nnz: int, num_blocks,
                   duration_ms: float, gflops: float):
        """A device-kernel row (the reference's log_*_cuda_benchmark,
        logger.c:131-152). ``kernel`` may be a strategy name or id."""
        if isinstance(kernel, str):
            kernel = STRATEGY_IDS.get(kernel, -1)
        f = self._files["cuda"]
        f.write(f"{matrix},{fmt},{kernel},{warps_per_block},{rows},{cols},"
                f"{nnz},{self._blocks(num_blocks)},{duration_ms:f},"
                f"{gflops:f}\n")
        f.flush()
