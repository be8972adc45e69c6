"""Distributed row-sharded SpMV over a device mesh.

ABSENT-IN-REF: the reference is strictly single-process / single-GPU
(SURVEY.md section 2, distributed rows) — this is the capability the
BASELINE.json config 5 adds: shard A's rows across devices, keep x
replicated, compute local SpMV per device, reassemble one global y.

Design (idiomatic JAX, not an MPI translation):

* 1-D mesh over the devices, axis ``"rows"``. Every GPU of a host
  reaches every other over NVLink at the same rate, so the mesh follows
  the algorithm alone.
* The nnz-balanced row partitioner (the OpenMP planner re-used as the
  shard planner — formats/csr.py:partition_rows_by_nnz, reference
  csr.c:218-276) chooses per-device row spans; spans are padded to
  equal row counts so shards have static identical shapes (SPMD
  requirement).
* Within ``shard_map``: x arrives replicated; each device runs the XLA
  gather + segment-sum local kernel and returns its padded rows.
  ``_unpad_rows`` then slices off each shard's padding and concatenates
  the shards into one global y, which XLA replicates on every device
  (an all-reduce on GPUs).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from spmv_scpa_tpu.formats.csr import CSR, partition_rows_by_nnz


def make_mesh(n_devices: int | None = None, devices=None, axis: str = "rows"):
    """1-D mesh over (CPU-virtual or real) devices."""
    import jax
    from jax.sharding import Mesh

    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def _unpad_rows(y_pad, bounds: np.ndarray, m: int):
    """Reassemble global y from per-shard padded rows ``(n_dev,
    h_pad)`` by STATIC slices (``bounds`` are host values, so every
    slice shape is compile-time) — no gather over all m rows."""
    import jax
    import jax.numpy as jnp
    n_dev = y_pad.shape[0]
    parts = [jax.lax.slice_in_dim(y_pad[d], 0,
                                  int(bounds[d + 1] - bounds[d]))
             for d in range(n_dev)]
    out = parts[0] if n_dev == 1 else jnp.concatenate(parts)
    assert out.shape[0] == m, (out.shape, m)
    return out


def plan_row_shards(A: CSR, n_shards: int) -> tuple[np.ndarray, int]:
    """nnz-balanced contiguous row spans + the padded uniform shard
    height (SPMD shards must have identical shapes)."""
    bounds = partition_rows_by_nnz(A.irp, n_shards)
    heights = np.diff(bounds)
    return bounds, int(heights.max(initial=0))


@dataclass
class RowShardedSpmv:
    """Prepared distributed SpMV: ``fn(x) -> y`` with y of length m.

    ``fn`` is jitted over the mesh; per-shard matrices are device-put
    according to the row sharding at build time.
    """

    mesh: object
    fn: object
    m: int
    n: int
    nnz: int
    bounds: np.ndarray
    shard_nnz: np.ndarray


def prepare_row_sharded(A: CSR, mesh=None, n_shards: int | None = None,
                        dtype=None):
    """Build the distributed SpMV.

    The local kernel is the XLA segment-sum CSR (always valid). Each
    shard's arrays are padded to uniform sizes: rows to the max span
    height, nnz to the max shard nnz (padded entries point at column 0
    with value 0 — the in-bounds dummy-read trick, cuda_hll.cu:176-195).
    """
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    if dtype is None:
        dtype = jnp.float32
    if mesh is None:
        mesh = make_mesh(n_shards)
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size

    bounds, h = plan_row_shards(A, n_dev)
    shard_nnz = np.diff(A.irp[bounds].astype(np.int64))
    max_nnz = int(shard_nnz.max(initial=1))
    max_nnz = max(max_nnz, 1)

    # Pack per-shard padded arrays: (n_dev, max_nnz) and (n_dev, h+1).
    ja = np.zeros((n_dev, max_nnz), dtype=np.int32)
    as_ = np.zeros((n_dev, max_nnz), dtype=np.float64)
    seg = np.full((n_dev, max_nnz), h - 1 if h else 0, dtype=np.int32)
    all_rows = A.row_ids()
    for d in range(n_dev):
        r0, r1 = int(bounds[d]), int(bounds[d + 1])
        lo, hi = int(A.irp[r0]), int(A.irp[r1])
        k = hi - lo
        ja[d, :k] = A.ja[lo:hi]
        as_[d, :k] = A.as_[lo:hi]
        seg[d, :k] = all_rows[lo:hi] - r0
        if k < max_nnz:
            seg[d, k:] = h  # dump segment (sliced off)

    shard = NamedSharding(mesh, P(axis))
    ja_d = jax.device_put(jnp.asarray(ja), shard)
    as_d = jax.device_put(jnp.asarray(as_, dtype), shard)
    seg_d = jax.device_put(jnp.asarray(seg), shard)

    def local_spmv(ja_s, as_s, seg_s, x):
        # one shard: (1, max_nnz) arrays, x replicated (n,)
        prod = as_s[0] * jnp.take(x.astype(dtype), ja_s[0])
        y = jax.ops.segment_sum(prod, seg_s[0], num_segments=h + 1,
                                indices_are_sorted=True)
        return y[None, :h]

    mapped = shard_map(local_spmv, mesh=mesh,
                       in_specs=(P(axis), P(axis), P(axis), P()),
                       out_specs=P(axis))

    m, n = A.m, A.n

    # matrix arrays travel as jit arguments, not baked-in constants;
    # shard bounds are host values (static slices in _unpad_rows), so
    # they are NOT traced arguments.
    def raw(x, ja_a, as_a, seg_a):
        y_pad = mapped(ja_a, as_a, seg_a, x)          # (n_dev, h)
        # unpad: shard d covers rows [bounds[d], bounds[d+1])
        return _unpad_rows(y_pad, bounds, m)

    jitted = jax.jit(raw)

    def fn(x):
        return jitted(x, ja_d, as_d, seg_d)

    out = RowShardedSpmv(mesh=mesh, fn=fn, m=m, n=n, nnz=A.nnz,
                         bounds=bounds, shard_nnz=shard_nnz)
    out.raw = raw
    out.args = (ja_d, as_d, seg_d)
    return out
