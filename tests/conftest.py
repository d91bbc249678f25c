"""Test configuration: an 8-device virtual CPU mesh, plus GPU-only tests.

The suite runs on the CPU: multi-device sharding is validated on a
virtual CPU mesh exactly like ``dryrun_multichip``, and Pallas kernels run
in interpret mode.  Tests marked ``gpu`` need a card; they skip here and
run on a GPU host with

    SPH_TEST_PLATFORMS=cpu,cuda python -m pytest tests/ -m gpu

(CPU stays the default device, so the mesh tests are unchanged; the
``gpu_device`` fixture hands GPU tests the card.)
"""
import os

os.environ["JAX_PLATFORMS"] = os.environ.get("SPH_TEST_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

assert jax.devices()[0].platform == "cpu", "tests run on the CPU backend"
assert len(jax.devices()) == 8, "tests expect an 8-device virtual CPU mesh"


# --- tiers ---------------------------------------------------------------
# `slow` tests are skipped unless --runslow; `gpu` tests skip (inside the
# gpu_device fixture) when no GPU backend is loaded.

def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run slow tests")


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: minutes-long tests")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (compiled kernels); skips without one")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow tier (run with --runslow)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test when JAX has no GPU backend."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU: run with SPH_TEST_PLATFORMS=cpu,cuda "
                    "on a GPU host")
    return devs[0]


@pytest.fixture(scope="session")
def dam_break_small():
    """Shared 2k-particle dam-break fixture (config-1 analogue, CPU-sized)."""
    from sph_tpu.core.params import FluidParams, SimConfig, compute_grid_dims
    from sph_tpu.core.state import spawn_standard, state_from_spawn

    spawn = spawn_standard(2048, seed=7)
    state = state_from_spawn(spawn)
    params = FluidParams.default().derive_mass()
    dims = compute_grid_dims(0, np.array([7.0, 7.0, 7.0]),
                             np.array([0.0, 0.0, 0.0]), 0.28)
    return state, params, dims
