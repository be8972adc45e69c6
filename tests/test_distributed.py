"""Distributed row-sharded SpMV on the 8-device virtual CPU mesh
(SURVEY.md section 4: the standard JAX answer to testing multi-device
paths without hardware)."""

import numpy as np
import pytest

from spmv_scpa_tpu import testing as synth
from spmv_scpa_tpu.ops.oracle import spmv_oracle
from spmv_scpa_tpu.parallel.distributed import (make_mesh, plan_row_shards,
                                                prepare_row_sharded)
from spmv_scpa_tpu.utils.validation import validate_result
from spmv_scpa_tpu.utils.vector import make_x


def _cpu_mesh(n):
    import jax
    return make_mesh(devices=jax.devices("cpu")[:n])


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_row_sharded_matches_oracle(n_dev):
    A = synth.banded_csr(500, row_nnz=9, bandwidth=60, seed=6)
    dist = prepare_row_sharded(A, mesh=_cpu_mesh(n_dev))
    x = make_x(A.n)
    got = np.asarray(dist.fn(x), dtype=np.float64)
    validate_result(spmv_oracle(A, x), got, what=f"dist n={n_dev}")


def test_row_sharded_powerlaw_imbalance():
    # nnz-balanced shard planner must handle skewed rows (config 4/5)
    A = synth.powerlaw_csr(600, 600, seed=12)
    dist = prepare_row_sharded(A, mesh=_cpu_mesh(8))
    x = make_x(A.n)
    validate_result(spmv_oracle(A, x), np.asarray(dist.fn(x)), what="dist-pl")
    # balance: max shard nnz within 2x ideal + one max row
    ideal = A.nnz / 8
    assert dist.shard_nnz.max() <= 2 * ideal + A.row_lengths().max()


def test_row_sharded_empty_shards():
    # more devices than meaningful rows → trailing empty shards
    A = synth.diag_csr(5)
    dist = prepare_row_sharded(A, mesh=_cpu_mesh(8))
    x = make_x(A.n)
    validate_result(spmv_oracle(A, x), np.asarray(dist.fn(x)), what="tiny")


def test_plan_row_shards_covers_all_rows():
    A = synth.random_csr(100, 100, density=0.05, seed=2)
    bounds, h = plan_row_shards(A, 4)
    assert bounds[0] == 0 and bounds[-1] == A.m
    assert h >= max(np.diff(bounds))


def test_four_card_phase_on_virtual_devices():
    """chip_smoke.py's four-card phase, run on 4 virtual CPU devices:
    shards on 4 distinct devices, agreement with the oracle and with
    the same path on 1 device."""
    import importlib.util
    import os

    import jax

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    A = synth.stencil_csr(3000, points=6, run_len=12, bandwidth=200)
    x = make_x(A.n)
    smoke.phase_four_cards(A, x, spmv_oracle(A, x), "cpu",
                           devices=jax.devices("cpu")[:4])
