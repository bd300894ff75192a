"""Test harness configuration.

Tests run on the CPU backend with 8 virtual devices, so the multi-device
sharding paths (fleet/) are exercised without accelerators. The platform is
pinned through jax.config before any backend initializes: the CPU unless
JAX_PLATFORMS names others.

Tests that need an NVIDIA GPU carry the `gpu` marker and take the `gpu`
fixture, which skips when JAX has no GPU. Run them on the card with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
# Entry points called in-process (cli.main) turn on the persistent compile
# cache; under test everything compiles in memory only.
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from badger_amcl.maps import CellState, OccupancyMap2D  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow (full E2E/robustness suite, ~10 min)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: slow E2E/robustness tests, skipped unless --runslow"
    )
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere (see module docstring)"
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow: run with --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture(scope="session")
def box_map():
    """40x40 @ 0.1 m map (world spans [-2, 2] m, center origin): border walls
    plus a pillar, with a 2 m distance field."""
    cells = np.full((40, 40), int(CellState.FREE), np.int8)
    cells[0, :] = cells[-1, :] = int(CellState.OCCUPIED)
    cells[:, 0] = cells[:, -1] = int(CellState.OCCUPIED)
    cells[18:22, 28:32] = int(CellState.OCCUPIED)  # pillar at world (~0.8..1.2, ~-0.2..0.2)
    return OccupancyMap2D.from_cells(cells, 0.1).with_distance_field(2.0)


@pytest.fixture(scope="session")
def gpu():
    """JAX's first GPU device; skips the test when there is none. Decided
    here, when a test asks for it, never at import or collection."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/")
