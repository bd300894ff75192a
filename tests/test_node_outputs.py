"""Output-path details: alt-frame duplicates, tf_reverse, full-state restore
through the node, phase timers."""

import numpy as np

from badger_amcl.config import AMCLConfig
from badger_amcl.node import make_node
from badger_amcl.sim import Sim2D, make_room_grid
import pytest


def _mk(**overrides):
    grid = make_room_grid(n=120, resolution=0.1, n_pillars=5)
    sim = Sim2D(grid, start_pose=(-2.0, -2.0, 0.2), n_beams=90)
    cfg = AMCLConfig.for_2d(
        min_particles=50, max_particles=400, laser_max_beams=30,
        update_min_d=0.05, update_min_a=0.05, **overrides,
    )
    node = make_node(cfg, tf_buffer=sim.tf)
    node.init_pose = np.array([-2.0, -2.0, 0.2])
    node.init_cov = np.array([0.2, 0.2, 0.05])
    node.map_msg_received(grid)
    return sim, node


def _drive(sim, node, steps):
    for _ in range(steps):
        odom = sim.step(0.3, 0.1)
        node.integrate_odom(odom)
        node.scan_received(sim.make_scan())
        node.spin_once(sim.t)


@pytest.mark.slow
def test_alt_frame_outputs():
    """global_alt_frame_id duplicates pose + particlecloud with the alt frame
    (node.cpp:137-143,351-356,438-444)."""
    sim, node = _mk(global_alt_frame_id="map_alt")
    alt_poses, alt_clouds = [], []
    node.subscribe_output("amcl_pose_in_map_alt", alt_poses.append)
    node.subscribe_output("particlecloud_in_map_alt", alt_clouds.append)
    _drive(sim, node, 6)
    assert alt_poses and alt_clouds
    assert alt_poses[-1].frame_id == "map_alt"
    assert alt_clouds[-1].frame_id == "map_alt"
    # alt-frame initial poses are accepted after frame rewrite (resolveFrameId)
    from badger_amcl.node.messages import PoseWithCovarianceStamped

    msg = PoseWithCovarianceStamped.make(sim.t, "map_alt", [1.0, 1.0, 0.0],
                                         np.array([0.05, 0.05, 0.02]))
    node.initial_pose_received(msg, sim.t)
    mean = np.asarray(node.state.stats.mean)
    np.testing.assert_allclose(mean[:2], [1.0, 1.0], atol=0.2)


def test_tf_reverse():
    """tf_reverse publishes odom->map instead of map->odom (node.cpp:894-904)."""
    sim_f, node_f = _mk()
    sim_r, node_r = _mk(tf_reverse=True)
    tfs_f, tfs_r = [], []
    node_f.subscribe_output("tf", tfs_f.append)
    node_r.subscribe_output("tf", tfs_r.append)
    _drive(sim_f, node_f, 6)
    _drive(sim_r, node_r, 6)
    f, r = tfs_f[-1], tfs_r[-1]
    assert (f.frame_id, f.child_frame_id) == ("map", "odom")
    assert (r.frame_id, r.child_frame_id) == ("odom", "map")
    # the two transforms are inverses of each other (same sim/seed)
    from badger_amcl.node.transforms import Transform

    tf_fwd = Transform(f.translation, f.rotation)
    tf_rev = Transform(r.translation, r.rotation)
    comp = tf_fwd.compose(tf_rev)
    np.testing.assert_allclose(comp.translation, 0.0, atol=1e-5)


def test_tf_broadcast_disabled():
    sim, node = _mk(tf_broadcast=False)
    tfs = []
    node.subscribe_output("tf", tfs.append)
    _drive(sim, node, 4)
    assert tfs == []


@pytest.mark.slow
def test_full_state_restore_through_node(tmp_path):
    sim, node = _mk()
    _drive(sim, node, 8)
    path = str(tmp_path / "state.npz")
    assert node.save_full_state(path)
    before = np.asarray(node.state.poses)

    sim2, node2 = _mk()
    assert node2.restore_full_state(path)
    np.testing.assert_array_equal(np.asarray(node2.state.poses), before)
    # keeps localizing from the snapshot
    node2.tf = sim.tf
    _drive(sim, node2, 6)
    _, est = node2.get_max_weight_pose()
    err = np.hypot(est[0] - sim.true_pose[0], est[1] - sim.true_pose[1])
    assert err < 0.4


def test_phase_timers_accumulate():
    sim, node = _mk()
    _drive(sim, node, 5)
    rep = node.timers.report()
    assert rep["sensor_update"]["count"] >= 1
    assert rep["scan_prep"]["count"] >= 1
    assert rep["resample"]["count"] >= 1
