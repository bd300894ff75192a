"""End-to-end 3D node tests: point-cloud localization against a voxel world."""

import math

import numpy as np
import pytest

from badger_amcl.config import AMCLConfig
from badger_amcl.node import make_node
from badger_amcl.node.messages import OccupancyGrid, OctomapMsg
from badger_amcl.node.transforms import Transform
from badger_amcl.sim import Sim3D
from badger_amcl.sensors.point_cloud import point_cloud_likelihood  # noqa: F401


def _voxel_room(size=8.0, res=0.1, height=1.0, seed=5):
    """Occupied voxel centers: four walls + columns, distinctive corners."""
    pts = []
    n = int(size / res)
    nz = int(height / res)
    rng = np.random.default_rng(seed)
    for k in range(nz):
        z = (k + 0.5) * res
        for i in range(n):
            x = (i + 0.5) * res
            pts += [[x, 0.5 * res, z], [x, size - 0.5 * res, z]]
            pts += [[0.5 * res, x, z], [size - 0.5 * res, x, z]]
    for _ in range(6):
        cx, cy = rng.uniform(1.0, size - 1.0, 2)
        for k in range(nz):
            pts.append([cx, cy, (k + 0.5) * res])
    return np.array(pts)


@pytest.fixture(scope="module")
def setup_3d():
    res = 0.1
    pts = _voxel_room(res=res)
    sim = Sim3D(pts, res, start_pose=(2.0, 2.0, 0.4), n_points=300)
    cfg = AMCLConfig.for_3d(
        min_particles=100,
        max_particles=800,
        update_min_d=0.05,
        update_min_a=0.05,
        cloud_max_beams=128,
        cloud_likelihood_max_dist=0.5,
        laser_model_type="likelihood_field",
        odom_alpha1=0.05, odom_alpha2=0.05, odom_alpha3=0.05,
        odom_alpha4=0.05, odom_alpha5=0.05,
    )
    return sim, cfg, pts, res


def _drive(sim, node, steps, v=0.25, w=0.2):
    for _ in range(steps):
        odom = sim.step(v, w)
        node.integrate_odom(odom)
        node.scan_received(sim.make_cloud())


@pytest.mark.slow
def test_tracking_3d(setup_3d):
    sim, cfg, pts, res = setup_3d
    node = make_node(cfg, tf_buffer=sim.tf)
    assert type(node).__name__ == "Node3D"
    node.init_pose = sim.true_pose.copy()
    node.init_cov = np.array([0.2, 0.2, 0.05])
    node.octomap_msg_received(OctomapMsg(resolution=res, occupied_centers=pts))
    assert node.map.distances_lut_created
    _drive(sim, node, 25)
    _, est = node.get_max_weight_pose()
    exy = math.hypot(est[0] - sim.true_pose[0], est[1] - sim.true_pose[1])
    eth = abs(math.remainder(est[2] - sim.true_pose[2], 2 * math.pi))
    assert exy < 0.3, exy
    assert eth < 0.25, eth


def test_tracking_3d_gompertz(setup_3d):
    sim0, cfg, pts, res = setup_3d
    sim = Sim3D(pts, res, start_pose=(2.0, 2.0, 0.4), n_points=300, seed=9)
    cfg = cfg.replace(
        laser_model_type="likelihood_field_gompertz",
        laser_gompertz_a=1.0, laser_gompertz_b=4.3, laser_gompertz_c=8.0,
        laser_gompertz_input_shift=-0.2, laser_gompertz_output_shift=0.02,
    )
    node = make_node(cfg, tf_buffer=sim.tf)
    node.init_pose = sim.true_pose.copy()
    node.init_cov = np.array([0.2, 0.2, 0.05])
    node.octomap_msg_received(OctomapMsg(resolution=res, occupied_centers=pts))
    _drive(sim, node, 25)
    _, est = node.get_max_weight_pose()
    exy = math.hypot(est[0] - sim.true_pose[0], est[1] - sim.true_pose[1])
    assert exy < 0.3, exy


def test_wait_for_occupancy_map_defers_bake(setup_3d):
    """wait_for_occupancy_map: the EDT bake waits for 2D bounds
    (node_3d.cpp:178-197,244-255)."""
    sim, cfg, pts, res = setup_3d
    cfg = cfg.replace(wait_for_occupancy_map=True)
    node = make_node(cfg, tf_buffer=sim.tf)
    node.octomap_msg_received(OctomapMsg(resolution=res, occupied_centers=pts))
    assert not node.map.distances_lut_created  # deferred
    # a scan before the bake is dropped
    node.scan_received(sim.make_cloud())
    grid = OccupancyGrid(width=40, height=40, resolution=0.2,
                         origin_x=0.0, origin_y=0.0,
                         data=np.zeros(1600, np.int8))
    node.occupancy_map_msg_received(grid)
    assert node.map.distances_lut_created
    assert node.free_space_indices is not None


def test_occupancy_bounds_ignore_grid_origin(setup_3d):
    """Regression: a non-zero-origin OccupancyGrid yields the SAME crop
    bounds as a zero-origin one. The reference hard-codes
    occupancy_map_min_ = {0.0, 0.0} and derives max from width/height alone,
    ignoring msg.info.origin entirely (node_3d.cpp:189-190) — preserved
    deliberately, not 'fixed'."""
    sim, cfg, pts, res = setup_3d
    cfg = cfg.replace(wait_for_occupancy_map=True)
    node = make_node(cfg, tf_buffer=sim.tf)
    node.octomap_msg_received(OctomapMsg(resolution=res, occupied_centers=pts))
    grid = OccupancyGrid(width=40, height=30, resolution=0.2,
                         origin_x=-3.5, origin_y=7.25,
                         data=np.zeros(1200, np.int8))
    node.occupancy_map_msg_received(grid)
    assert node.occupancy_map_min == [0.0, 0.0]
    assert node.occupancy_map_max == [pytest.approx(8.0), pytest.approx(6.0)]
    assert node.map.distances_lut_created


def test_scanner_mount_extrinsic(setup_3d):
    """A mounted (translated + yawed) lidar must still localize — exercises
    the scanner->footprint fold-in (getMapCloud equivalent)."""
    _, cfg, pts, res = setup_3d
    mount = Transform.from_xyzrpy(0.3, 0.1, 0.5, 0.0, 0.0, 0.8)
    sim = Sim3D(pts, res, start_pose=(2.0, 2.0, 0.4), n_points=300,
                scanner_mount=mount, seed=11)
    node = make_node(cfg, tf_buffer=sim.tf)
    node.init_pose = sim.true_pose.copy()
    node.init_cov = np.array([0.2, 0.2, 0.05])
    node.octomap_msg_received(OctomapMsg(resolution=res, occupied_centers=pts))
    _drive(sim, node, 25)
    _, est = node.get_max_weight_pose()
    exy = math.hypot(est[0] - sim.true_pose[0], est[1] - sim.true_pose[1])
    assert exy < 0.3, exy


def test_octomap_binary_bt_through_node(setup_3d, tmp_path):
    """The binary .bt octree payload path (octoMapMsgReceived binary branch,
    node_3d.cpp:262-284)."""
    import os

    from badger_amcl.maps.octree_io import write_bt

    sim, cfg, pts, res = setup_3d
    path = str(tmp_path / "world.bt")
    thin = pts[:: max(1, len(pts) // 1500)]
    write_bt(path, res, thin)
    with open(path, "rb") as f:
        payload = f.read()
    node = make_node(cfg, tf_buffer=sim.tf)
    node.octomap_msg_received(OctomapMsg(resolution=res, binary_data=payload))
    assert node.map is not None and node.map.distances_lut_created
    assert node.map.resolution == res
    # occupied voxels survived the roundtrip (octree key quantization:
    # floor(c/res), distinct from the map's floor(c/res + 0.5) cells)
    assert len(node.map.occupied_cells) == len(np.unique(
        np.floor(thin / res).astype(int), axis=0))
