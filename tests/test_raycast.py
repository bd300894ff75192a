"""Bresenham raycast: reference gtest cases + oracle comparison.

The two golden cases come from testOccupancyMapDistances
(test/test_badger_amcl.cpp:131-171); the fuzz comparison uses a direct
Python transcription of the calcRange contract (occupancy_map.cpp:257-364)
as oracle.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from badger_amcl.maps import CellState, OccupancyMap2D
from badger_amcl.sensors.raycast import calc_range


@pytest.fixture(scope="module")
def ref_map():
    """The reference test map: 100x150 @0.05, origin (2.5, 3.75), UNKNOWN
    strip at x=1, y in (2,12); OCCUPIED bars at x in (4,14), y in {10, 15}."""
    cells = np.full((150, 100), int(CellState.FREE), np.int8)
    for x in range(100):
        for y in range(150):
            if x == 1 and 2 < y < 12:
                cells[y, x] = int(CellState.UNKNOWN)
            elif 4 < x < 14 and (y == 10 or y == 15):
                cells[y, x] = int(CellState.OCCUPIED)
    return OccupancyMap2D.from_cells(cells, 0.05, origin_x=50 * 0.05, origin_y=75 * 0.05)


def test_reference_golden_cases(ref_map):
    r = calc_range(ref_map, jnp.array(0.0), jnp.array(0.0), jnp.array(0.0), 0.0)
    assert float(r) == 0.0
    r = calc_range(ref_map, jnp.array(0.05), jnp.array(0.0), jnp.array(1.5708), 0.5)
    np.testing.assert_allclose(float(r), 0.15, atol=1e-6)


def _oracle_calc_range(m, ox, oy, oa, max_range):
    """Literal transcription of occupancy_map.cpp:257-364."""
    cells = np.asarray(m.cells)

    def w2m(x, y):
        i = math.floor((x - m.origin_x) / m.resolution + 0.5) + m.size_x // 2
        j = math.floor((y - m.origin_y) / m.resolution + 0.5) + m.size_y // 2
        return i, j

    def free(i, j):
        if not (0 <= i < m.size_x and 0 <= j < m.size_y):
            return False
        return cells[j, i] == int(CellState.FREE)

    x0, y0 = w2m(ox, oy)
    x1, y1 = w2m(ox + max_range * math.cos(oa), oy + max_range * math.sin(oa))
    if x0 == x1 and y0 == y1:
        return max_range
    steep = abs(y1 - y0) > abs(x1 - x0)
    if steep:
        x0, y0, x1, y1 = y0, x0, y1, x1
    deltax, deltay = abs(x1 - x0), abs(y1 - y0)
    error, deltaerr = 0, deltay
    x, y = x0, y0
    xstep = 1 if x0 < x1 else -1
    ystep = 1 if y0 < y1 else -1

    def check(x, y):
        i, j = (y, x) if steep else (x, y)
        return not free(i, j)

    if check(x, y):
        return math.hypot(x - x0, y - y0) * m.resolution
    while x != x1 + xstep:
        x += xstep
        error += deltaerr
        if 2 * error >= deltax:
            y += ystep
            error -= deltax
        if check(x, y):
            return math.hypot(x - x0, y - y0) * m.resolution
    return max_range


def test_fuzz_against_oracle(ref_map):
    rng = np.random.default_rng(7)
    n = 200
    ox = rng.uniform(-2.2, 2.2, n)
    oy = rng.uniform(-3.5, 3.5, n)
    oa = rng.uniform(-np.pi, np.pi, n)
    got = np.asarray(
        calc_range(ref_map, jnp.asarray(ox, jnp.float32), jnp.asarray(oy, jnp.float32),
                   jnp.asarray(oa, jnp.float32), 3.0)
    )
    for k in range(n):
        want = _oracle_calc_range(ref_map, float(np.float32(ox[k])), float(np.float32(oy[k])),
                                  float(np.float32(oa[k])), 3.0)
        assert abs(got[k] - want) < 1e-4, (k, ox[k], oy[k], oa[k], got[k], want)


def test_batched_shapes(box_map):
    r = calc_range(
        box_map,
        jnp.zeros((5, 1)),
        jnp.zeros((5, 1)),
        jnp.linspace(0, 2 * np.pi, 8)[None, :],
        5.0,
    )
    assert r.shape == (5, 8)
    # from the center every ray hits the pillar (0.8 m at angle 0) or a wall
    assert (np.asarray(r) < 3.0).all()
    assert (np.asarray(r) >= 0.8 - 1e-6).all()
