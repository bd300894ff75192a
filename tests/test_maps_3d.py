"""3D map layer: conversions, voxel EDT quantization contract, bounds
cropping, .bt octree IO roundtrip.

Mirrors testOctoMapConversions (test/test_badger_amcl.cpp:84-111) and the
quantized storage contract (octomap.cpp:315-350).
"""

import numpy as np
import jax.numpy as jnp

from badger_amcl.maps import OctoMap3D
from badger_amcl.maps.octree_io import read_bt, write_bt
import pytest


def _mk_map(res=0.05, max_dist=0.3):
    # a single occupied voxel at cell (10, 10, 10) inside a 21^3 volume
    pts = np.array([[10 * res, 10 * res, 10 * res]])
    m = OctoMap3D.from_occupied_points(
        pts, res, max_dist, metric_min=(0, 0, 0),
        metric_max=(20 * res, 20 * res, 20 * res),
    )
    return m.with_distance_field()


def test_conversions_reference_cases():
    m = OctoMap3D.from_occupied_points(np.zeros((1, 3)), 0.05, 0.3)
    # 2D case from testOctoMapConversions
    np.testing.assert_allclose(
        np.asarray(m.map_to_world(jnp.array([1, 2, 0])))[:2], [0.05, 0.1], atol=1e-7
    )
    np.testing.assert_array_equal(
        np.asarray(m.world_to_map(jnp.array([0.05, 0.1, 0.0])))[:2], [1, 2]
    )
    # 3D incl. negative coords
    np.testing.assert_array_equal(
        np.asarray(m.world_to_map(jnp.array([0.15, 0.25, -0.05]))), [3, 5, -1]
    )
    np.testing.assert_allclose(
        np.asarray(m.map_to_world(jnp.array([3, 5, -1]))), [0.15, 0.25, -0.05],
        atol=1e-7,
    )


def test_edt_quantization_contract():
    """ratio = floor(min(d, max)/max * 255); read back ratio * max/255
    (octomap.cpp:328-332,336-350)."""
    m = _mk_map()
    res, max_dist = 0.05, 0.3
    d0 = float(m.distance_at(jnp.array([10, 10, 10])))
    assert d0 == 0.0
    d1 = float(m.distance_at(jnp.array([11, 10, 10])))
    want = np.floor(res / max_dist * 255) * (max_dist / 255)
    np.testing.assert_allclose(d1, want, atol=1e-6)
    d_diag = float(m.distance_at(jnp.array([12, 12, 11])))
    true_d = np.sqrt(4 + 4 + 1) * res
    want_diag = np.floor(min(true_d, max_dist) / max_dist * 255) * (max_dist / 255)
    np.testing.assert_allclose(d_diag, want_diag, atol=1e-6)
    # far voxels saturate at max (ratio 255 * max/255, f32 round-off)
    np.testing.assert_allclose(
        float(m.distance_at(jnp.array([0, 0, 0]))), max_dist, rtol=1e-6
    )


def test_out_of_bounds_returns_max():
    m = _mk_map()
    assert float(m.distance_at(jnp.array([100, 0, 0]))) == np.float32(0.3)
    assert float(m.distance_at(jnp.array([-5, 10, 10]))) == np.float32(0.3)
    assert bool(m.is_pose_valid(jnp.int32(10), jnp.int32(10)))
    assert not bool(m.is_pose_valid(jnp.int32(100), jnp.int32(10)))


def test_set_map_bounds_crops_and_rebakes():
    res = 0.1
    pts = np.array([[0.5, 0.5, 0.5], [3.0, 3.0, 0.5]])
    m = OctoMap3D.from_occupied_points(
        pts, res, 0.4, metric_min=(0, 0, 0), metric_max=(4.0, 4.0, 1.0)
    ).with_distance_field()
    # crop to [0, 1.5]^2: the (3, 3) obstacle falls outside (and outside the
    # pad), so distances inside the crop reference only the first obstacle
    cropped = m.set_map_bounds([0.0, 0.0], [1.5, 1.5])
    assert cropped.max_cells[0] <= int(np.floor((1.5 + 0.4) / res + 0.5))
    d = float(cropped.distance_at(jnp.array([5, 5, 5])))
    assert d == 0.0  # the (0.5, 0.5, 0.5) obstacle survives the crop
    # in-bounds voxel far from obstacle 1 saturates despite obstacle 2
    far = cropped.world_to_map(jnp.array([1.5, 1.5, 0.5]))
    assert float(cropped.distance_at(far)) == np.float32(0.4)


def test_bt_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    centers = (rng.integers(-20, 20, (50, 3)) + 0.5) * 0.1
    centers = np.unique(centers, axis=0)
    path = str(tmp_path / "map.bt")
    write_bt(path, 0.1, centers)
    tree = read_bt(path)
    assert tree.resolution == 0.1
    got = tree.occupied_centers()
    got_sorted = got[np.lexsort(got.T)]
    want_sorted = centers[np.lexsort(centers.T)]
    np.testing.assert_allclose(got_sorted, want_sorted, atol=1e-9)


def test_ot_roundtrip_matches_binary_twin(tmp_path):
    """A full-format (.ot) fixture decodes to the same voxel set as its
    binary (.bt) twin (the binary-or-full branch, node_3d.cpp:262-284)."""
    from badger_amcl.maps.octree_io import read_octree, read_ot, write_ot

    rng = np.random.default_rng(7)
    centers = (rng.integers(-20, 20, (50, 3)) + 0.5) * 0.1
    centers = np.unique(centers, axis=0)
    bt_path, ot_path = str(tmp_path / "m.bt"), str(tmp_path / "m.ot")
    write_bt(bt_path, 0.1, centers)
    write_ot(ot_path, 0.1, centers)
    vb = read_bt(bt_path).occupied_centers()
    vf = read_ot(ot_path).occupied_centers()
    vb = vb[np.lexsort(vb.T)]
    vf = vf[np.lexsort(vf.T)]
    np.testing.assert_allclose(vf, vb, atol=1e-9)
    # dispatching reader picks the right format from the header
    vd = read_octree(ot_path).occupied_centers()
    assert len(vd) == len(vf)


@pytest.mark.slow
def test_node3d_accepts_full_octomap_msg():
    """Full probabilistic octomap messages initialize the 3D node's map
    (fullMsgToMap branch, node_3d.cpp:270-273)."""
    import io

    from badger_amcl.config import AMCLConfig
    from badger_amcl.maps.octree_io import write_ot
    from badger_amcl.node.messages import OctomapMsg
    from badger_amcl.node.node_3d import Node3D

    centers = np.array([[0.05, 0.05, 0.05], [0.35, 0.25, 0.15]])
    import tempfile, os

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "m.ot")
        write_ot(p, 0.1, centers)
        blob = open(p, "rb").read()
    node = Node3D(AMCLConfig.for_3d(min_particles=10, max_particles=50))
    node.octomap_msg_received(OctomapMsg(resolution=0.1, full_data=blob))
    assert node.map is not None
    d0 = float(node.map.distance_at(node.map.world_to_map(
        np.array([0.05, 0.05, 0.05]))))
    assert d0 == 0.0


def test_free_space_indices_cover_footprint():
    m = _mk_map()
    fsi = m.free_space_indices()
    assert fsi.shape == (20 * 20, 2)  # exclusive of max cell (node_3d.cpp:314-315)
    assert fsi.min() == 0 and fsi.max() == 19
