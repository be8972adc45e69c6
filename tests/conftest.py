"""Test configuration: JAX on the CPU backend with 8 virtual devices,
so the multi-device sharding paths run without GPUs (the standard JAX
answer to testing distributed code, SURVEY.md section 4).

Must run before any ``import jax`` materializes a backend. Tests that
need a GPU carry the ``gpu`` marker and take the ``gpu`` fixture, which
skips them here with a reason.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_default_device", jax.devices("cpu")[0])

from spmv_scpa_tpu import testing as synth  # noqa: E402


@pytest.fixture()
def gpu():
    """The GPU this test needs; decided when the test runs, never at
    import or collection (xdist workers must collect the same tests)."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run on the card: pytest -m gpu)")
    return devs[0]


@pytest.fixture(scope="session")
def matrices():
    """A small zoo spanning the structural archetypes."""
    return [
        synth.tiny_fixture_csr(),
        synth.diag_csr(37),
        synth.banded_csr(256, row_nnz=9, bandwidth=40, seed=1),
        synth.banded_csr(300, 200, row_nnz=7, bandwidth=64, seed=2),
        synth.random_csr(200, 300, density=0.02, seed=3),
        synth.powerlaw_csr(400, 400, seed=4),
        synth.amazon_csr(m=3000, seed=6),
    ]


@pytest.fixture()
def rng():
    return np.random.default_rng(1234)
