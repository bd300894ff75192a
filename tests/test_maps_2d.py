"""2D map layer: conversions, EDT contract, cell states.

Mirrors and extends the reference's gtest cases
(test/test_badger_amcl.cpp:113-171 testOccupancyMapConversions /
testOccupancyMapDistances); EDT values are checked against a brute-force
exact nearest-obstacle search, which is the ground-truth contract.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from badger_amcl.maps import CellState, OccupancyMap2D, grid_from_probabilities
from badger_amcl.maps.edt import edt_2d


def test_conversion_roundtrip_matches_reference_case():
    # testOccupancyMapConversions: res 0.05, default origin (0,0), size 0
    m = OccupancyMap2D.from_cells(np.zeros((0, 0), np.int8), 0.05)
    world = m.map_to_world(jnp.array([1, 2]))
    np.testing.assert_allclose(np.asarray(world), [0.05, 0.1], atol=1e-7)
    ij = m.world_to_map(jnp.array([0.05, 0.1]))
    np.testing.assert_array_equal(np.asarray(ij), [1, 2])


def test_center_origin_convention():
    # size 100x150 @0.05 with origin at (size/2*res) like testOccupancyMapDistances
    cells = np.full((150, 100), int(CellState.FREE), np.int8)
    m = OccupancyMap2D.from_cells(cells, 0.05, origin_x=50 * 0.05, origin_y=75 * 0.05)
    # world (0,0) -> cell (0,0): floor((0-2.5)/.05+.5)+50 = floor(-49.5)+50 = 0
    np.testing.assert_array_equal(np.asarray(m.world_to_map(jnp.zeros(2))), [0, 0])
    # roundtrip through cell centers
    ij = jnp.array([[3, 7], [99, 149], [0, 0]])
    back = m.world_to_map(m.map_to_world(ij))
    np.testing.assert_array_equal(np.asarray(back), np.asarray(ij))


def test_is_valid_bounds():
    cells = np.zeros((150, 100), np.int8)
    m = OccupancyMap2D.from_cells(cells, 0.05)
    assert bool(m.is_valid(jnp.array([0, 0])))
    assert not bool(m.is_valid(jnp.array([-1, 5])))
    assert bool(m.is_valid(jnp.array([99, 149])))
    assert not bool(m.is_valid(jnp.array([100, 150])))
    assert not bool(m.is_valid(jnp.array([149, 99])))


def test_grid_from_probabilities():
    data = np.array([0, 100, 50, -1, 0])
    states = grid_from_probabilities(data)
    assert states.tolist() == [-1, 1, 0, 0, -1]


def _brute_force_edt(occ):
    h, w = occ.shape
    ys, xs = np.nonzero(occ)
    if len(ys) == 0:
        return np.full(occ.shape, np.inf)
    out = np.empty(occ.shape)
    for j in range(h):
        for i in range(w):
            out[j, i] = np.min(np.sqrt((ys - j) ** 2 + (xs - i) ** 2))
    return out


def test_edt_exact_vs_brute_force():
    rng = np.random.default_rng(0)
    occ = rng.random((23, 31)) < 0.07
    occ[4, 7] = True  # ensure nonempty
    got = edt_2d(occ)
    want = _brute_force_edt(occ)
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_distance_field_cap_contract():
    """Reference rule: cells with d_cells <= floor(max_dist/res) read
    d_cells*res; everything farther reads exactly max_dist
    (occupancy_map.cpp:181,224-242)."""
    cells = np.full((50, 50), int(CellState.FREE), np.int8)
    cells[25, 25] = int(CellState.OCCUPIED)
    res, max_dist = 0.05, 0.3
    m = OccupancyMap2D.from_cells(cells, res).with_distance_field(max_dist)
    d = np.asarray(m.distances)
    assert d[25, 25] == 0.0
    assert abs(d[25, 26] - res) < 1e-6
    assert abs(d[25, 31] - 6 * res) < 1e-6  # exactly at cell_radius=6
    assert d[25, 32] == np.float32(max_dist)  # 7 cells away -> capped
    # diagonal: sqrt(5^2+4^2)=6.40 > 6 -> capped even though 0.32 > 0.3 anyway
    assert d[29, 30] == np.float32(max_dist)


def test_distance_at_out_of_bounds_returns_max():
    cells = np.full((10, 10), int(CellState.FREE), np.int8)
    cells[5, 5] = int(CellState.OCCUPIED)
    m = OccupancyMap2D.from_cells(cells, 0.1).with_distance_field(0.5)
    d = m.distance_at(jnp.array([[100, 100], [5, 5]]))
    np.testing.assert_allclose(np.asarray(d), [0.5, 0.0], atol=1e-6)


def test_supersampling_conversion():
    """map_scale_up_factor supersampling (node_2d.cpp:265-295)."""
    data = np.array([[0, 100], [-1, 0]], np.int8).ravel()
    m = OccupancyMap2D.from_occupancy_grid_msg(
        width=2, height=2, resolution=0.2, origin_position_x=0.0,
        origin_position_y=0.0, data=data, map_scale_up_factor=2,
    )
    assert (m.size_x, m.size_y) == (4, 4)
    assert m.resolution == pytest.approx(0.1)
    assert m.origin_x == pytest.approx(0.0 + 2 * 0.1)
    c = np.asarray(m.cells)
    assert (c[0:2, 0:2] == int(CellState.FREE)).all()
    assert (c[0:2, 2:4] == int(CellState.OCCUPIED)).all()
    assert (c[2:4, 0:2] == int(CellState.UNKNOWN)).all()


def test_free_space_indices(box_map):
    fsi = box_map.free_space_indices(non_free_space_radius=0.0)
    cells = np.asarray(box_map.cells)
    assert len(fsi) == (cells == int(CellState.FREE)).sum()
    fsi_far = box_map.free_space_indices(non_free_space_radius=0.3)
    assert 0 < len(fsi_far) < len(fsi)
    d = np.asarray(box_map.distances)
    assert (d[fsi_far[:, 1], fsi_far[:, 0]] > 0.3).all()
