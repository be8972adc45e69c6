"""Differential kernel tests: every strategy vs the fp64 golden oracle
on every archetype matrix — the reference's `-d` validation flow
(main.c:140-146, utils.c:39-60) promoted to a proper test suite."""

import numpy as np
import pytest

from spmv_scpa_tpu.ops.oracle import spmv_oracle, spmm_oracle
from spmv_scpa_tpu.ops.registry import get_strategy, list_strategies
from spmv_scpa_tpu.utils.validation import validate_result
from spmv_scpa_tpu.utils.vector import make_x


# spmm-only strategies take (n, c) inputs, and the Pallas kernel needs
# interpret=True off the GPU — both are tested separately
ALL_STRATEGIES = sorted(
    s for s in set(list_strategies())
    if (not get_strategy(s).spmm or s == "xla-csr-segsum")
    and get_strategy(s).backend != "pallas")


@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
def test_strategy_matches_oracle(matrices, strategy):
    spec = get_strategy(strategy)
    for A in matrices:
        x = make_x(A.n)
        expected = spmv_oracle(A, x)
        prep = spec.prepare(A)
        got = np.asarray(prep.fn(x), dtype=np.float64)
        validate_result(expected, got, what=f"{strategy} on {A.name}")


def test_empty_rows_and_cols():
    from spmv_scpa_tpu.formats.csr import CSR
    dense = np.zeros((10, 7))
    dense[2, 3] = 4.0
    dense[9, 0] = -1.0
    A = CSR.from_dense("sparse10", dense)
    x = make_x(A.n)
    expected = spmv_oracle(A, x)
    for s in ALL_STRATEGIES:
        got = np.asarray(get_strategy(s).prepare(A).fn(x))
        validate_result(expected, got, what=s)
    from spmv_scpa_tpu.ops import hell
    from spmv_scpa_tpu.ops.registry import bind
    E = hell.hell_layout(A)   # 2 nonzeros: fill is below the plan's
    got = bind(*hell.make_hell(E, A.m, interpret=True))(x)
    validate_result(expected, np.asarray(got), what="pallas-hell")


def test_empty_windows_all_empty_matrix():
    """A matrix with zero nonzeros spanning many row slices gives a
    full-length all-zero y on every device path."""
    from spmv_scpa_tpu.formats.csr import CSR
    A = CSR.from_coo("all_empty", 4000, 64, np.array([], np.int64),
                     np.array([], np.int64), np.array([], np.float64))
    x = make_x(A.n)
    for s, kw in (("pallas-hell", {"interpret": True}),
                  ("xla-csr-segsum", {}), ("xla-ell-cm", {})):
        got = np.asarray(get_strategy(s).prepare(A, **kw).fn(x))
        assert got.shape == (4000,)
        assert np.all(got == 0.0), s


def test_spmm_oracle_matches_dense():
    from spmv_scpa_tpu import testing as synth
    A = synth.random_csr(50, 60, density=0.05, seed=8)
    X = make_x(A.n, cols=8)
    np.testing.assert_allclose(spmm_oracle(A, X), A.to_dense() @ X,
                               rtol=1e-12)


@pytest.mark.parametrize("cols", [8, 64])
def test_spmm_segsum(cols):
    """SpMM at the two widths BASELINE.json config 3 names."""
    from spmv_scpa_tpu import testing as synth
    A = synth.banded_csr(100, row_nnz=6, bandwidth=30, seed=2)
    X = make_x(A.n, cols=cols)
    prep = get_strategy("xla-csr-segsum-spmm").prepare(A, cols=cols)
    validate_result(spmm_oracle(A, X), np.asarray(prep.fn(X)),
                    what=f"spmm cols={cols}")


def test_auto_strategy():
    from spmv_scpa_tpu import testing as synth
    from spmv_scpa_tpu.ops.registry import spmv
    A = synth.banded_csr(64, row_nnz=4, bandwidth=12, seed=3)
    x = make_x(A.n)
    validate_result(spmv_oracle(A, x), spmv(A, x), what="auto")


def test_spmv_drives_spmm_only_strategies_with_1d_x():
    """Every list_strategies() entry is drivable through the one-shot
    spmv() API: SpMM-only strategies take a 1-D x via column-0
    ride-through (the verify-skill E2E drive relies on this)."""
    from spmv_scpa_tpu import testing as synth
    from spmv_scpa_tpu.ops.registry import get_strategy, spmv
    A = synth.banded_csr(100, row_nnz=6, bandwidth=30, seed=2)
    x = make_x(A.n)
    expected = spmv_oracle(A, x)
    spec = get_strategy("xla-csr-segsum-spmm")
    assert spec.spmm_only
    validate_result(expected, spmv(A, x, "xla-csr-segsum-spmm"),
                    what="spmm-only via spmv()")


def test_validation_rejects_garbage():
    from spmv_scpa_tpu.errors import ValidationError
    expected = np.full(1000, 100.0)
    with pytest.raises(ValidationError):
        validate_result(expected, expected + 1.0)
    with pytest.raises(ValidationError):
        validate_result(expected, expected[:-1])
    # within reference absolute epsilon (utils.c:53) passes
    validate_result(expected, expected + 1e-4)


def test_df64_matches_oracle_tight():
    """df64 strategy must hit ~1e-9 relative error vs the fp64 oracle
    (plain f32 sits at ~1e-7) — the fp64-equivalence knob."""
    from spmv_scpa_tpu import testing as synth
    from spmv_scpa_tpu.utils.validation import l2_error
    A = synth.banded_csr(300, row_nnz=13, bandwidth=64, runs=3, seed=21)
    x = make_x(A.n)
    gold = spmv_oracle(A, x)
    prep = get_strategy("xla-ell-df64").prepare(A)
    got = np.asarray(prep.fn(x), dtype=np.float64)
    rel = l2_error(gold, got) / np.linalg.norm(gold)
    assert rel < 1e-9, rel


def test_xla_dense_asks_for_highest_precision():
    """An f32 matmul may run in TF32 on the GPU unless the program asks
    for full precision; the dense path must ask."""
    import jax
    from spmv_scpa_tpu import testing as synth
    from spmv_scpa_tpu.ops import xla as xla_ops
    A = synth.random_csr(20, 30, density=0.2, seed=1)
    raw, args = xla_ops.make_dense(A)
    jaxpr = str(jax.make_jaxpr(raw)(np.ones(A.n, np.float32), *args))
    assert "dot_general" in jaxpr and "HIGHEST" in jaxpr, jaxpr
