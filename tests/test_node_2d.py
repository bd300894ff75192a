"""End-to-end 2D node tests: the integration coverage the reference never had
(SURVEY.md §4) — synthetic map + scripted trajectory + raycast scans; the
filter must track within Monte-Carlo tolerance.
"""

import math

import numpy as np
import pytest

from badger_amcl.config import AMCLConfig
from badger_amcl.node import make_node
from badger_amcl.node.messages import PoseWithCovarianceStamped
from badger_amcl.sim import Sim2D, make_room_grid


def _mk(config_overrides=None, sim_overrides=None, start=(-3.0, -3.0, 0.3)):
    grid = make_room_grid(n=160, resolution=0.075, n_pillars=8)
    sim = Sim2D(grid, start_pose=start, n_beams=120, **(sim_overrides or {}))
    base = dict(
        min_particles=100,
        max_particles=1000,
        laser_max_beams=40,
        update_min_d=0.05,
        update_min_a=0.05,
        odom_alpha1=0.05, odom_alpha2=0.05, odom_alpha3=0.05,
        odom_alpha4=0.05, odom_alpha5=0.05,
    )
    base.update(config_overrides or {})
    cfg = AMCLConfig.for_2d(**base)
    node = make_node(cfg, tf_buffer=sim.tf)
    node.init_pose = np.asarray(start, float)
    node.init_cov = np.array([0.25, 0.25, 0.05])
    node.map_msg_received(grid)
    return sim, node


def _drive(sim, node, steps, v=0.3, w=0.15, collect=None):
    for _ in range(steps):
        odom = sim.step(v, w)
        node.integrate_odom(odom)
        node.scan_received(sim.make_scan())
        node.spin_once(sim.t)
        if collect is not None:
            collect()


def _pose_err(sim, node):
    _, est = node.get_max_weight_pose()
    exy = math.hypot(est[0] - sim.true_pose[0], est[1] - sim.true_pose[1])
    eth = abs(math.remainder(est[2] - sim.true_pose[2], 2 * math.pi))
    return exy, eth


@pytest.mark.parametrize("model", ["likelihood_field", "beam", "likelihood_field_prob",
                                   "likelihood_field_gompertz"])
@pytest.mark.slow
def test_tracking_all_models(model):
    overrides = {"laser_model_type": model}
    if model == "likelihood_field_gompertz":
        overrides.update(
            laser_gompertz_a=1.0, laser_gompertz_b=4.3, laser_gompertz_c=8.0,
            laser_gompertz_input_shift=-0.2, laser_gompertz_output_shift=0.02,
        )
    if model == "beam":
        overrides.update(laser_max_beams=20)  # raycast is the slow path on CPU
    sim, node = _mk(overrides)
    _drive(sim, node, 25)
    exy, eth = _pose_err(sim, node)
    assert exy < 0.3, (model, exy)
    assert eth < 0.25, (model, eth)


def test_outputs_published():
    sim, node = _mk()
    poses, clouds, tfs = [], [], []
    node.subscribe_output("amcl_pose", poses.append)
    node.subscribe_output("particlecloud", clouds.append)
    node.subscribe_output("tf", tfs.append)
    _drive(sim, node, 10)
    assert poses and clouds and tfs
    # amcl_pose carries the 6x6 covariance with xy block + yaw var
    p = poses[-1]
    assert p.covariance.shape == (36,)
    assert p.covariance[0] > 0 and p.covariance[35] > 0
    assert p.frame_id == "map"
    # particlecloud matches the active population
    assert clouds[-1].poses.shape[1] == 3
    # map->odom tf invariant: composing with odometry *at the pose's stamp*
    # reproduces the published pose (the whole point of the map->odom TF)
    from badger_amcl.node.transforms import Transform

    tf = tfs[-1]
    t_map_odom = Transform(tf.translation, tf.rotation)
    t_odom_base = sim.tf.lookup("odom", "base_link", poses[-1].stamp)
    est_base = t_map_odom.compose(t_odom_base).to_pose2d()
    np.testing.assert_allclose(est_base[:2], poses[-1].pose[:2], atol=1e-5)


def test_update_gating_no_motion():
    """Without motion beyond the thresholds the filter must not update
    (updatePf / setScannersUpdateFlags)."""
    sim, node = _mk(config_overrides={"update_min_d": 0.5, "update_min_a": 1.0})
    # first scan initializes odom and forces an update
    odom = sim.step(0.0, 0.0)
    node.integrate_odom(odom)
    node.scan_received(sim.make_scan())
    w0 = float(node.state.w_fast)
    # robot stands still: subsequent scans are gated
    for _ in range(5):
        odom = sim.step(0.0, 0.0)
        node.integrate_odom(odom)
        node.scan_received(sim.make_scan())
    assert float(node.state.w_fast) == w0  # no sensor updates happened


@pytest.mark.slow
def test_global_localization_recovers():
    """Kidnapped robot: the global_localization service (node.cpp:870-883)
    scatters particles uniformly — here with the reference's score-rejected
    pose generation (uniform_pose_starting_weight_threshold,
    node.cpp:847-868) enabled, without which a few thousand particles over a
    12 m x 12 m x 2pi space starve the true basin. The filter must
    re-acquire the true pose."""
    sim, node = _mk(
        config_overrides={
            "min_particles": 200,
            "max_particles": 4000,
            "uniform_pose_starting_weight_threshold": 3.0,
            "uniform_pose_deweight_multiplier": 0.95,
            "global_localization_alpha_slow": 0.001,
            "global_localization_alpha_fast": 0.1,
        }
    )
    _drive(sim, node, 8)
    sim.teleport((3.0, 3.0, -2.0))
    node.global_localization()
    assert node.global_localization_active
    _drive(sim, node, 40, v=0.5, w=0.4)
    exy, _ = _pose_err(sim, node)
    assert exy < 0.5, exy
    w, _ = node.get_max_weight_pose()
    assert w > 0.6  # dominant hypothesis carries the mass
    # KLD adaptation shrank the population once concentrated
    assert int(node.state.n_active) < 1000


def test_initial_pose_intake():
    sim, node = _mk()
    _drive(sim, node, 4)
    # inject a deliberately wrong initial pose in the global frame
    msg = PoseWithCovarianceStamped.make(sim.t, "map", [2.0, 2.0, 1.0],
                                         np.array([0.04, 0.04, 0.01]))
    node.initial_pose_received(msg, sim.t)
    mean = np.asarray(node.state.stats.mean)
    np.testing.assert_allclose(mean[:2], [2.0, 2.0], atol=0.15)
    # wrong frame is ignored
    before = np.asarray(node.state.poses)
    bad = PoseWithCovarianceStamped.make(sim.t, "other_frame", [0, 0, 0], None)
    node.initial_pose_received(bad, sim.t)
    np.testing.assert_array_equal(before, np.asarray(node.state.poses))
    # NaN pose is ignored
    bad2 = PoseWithCovarianceStamped.make(sim.t, "map", [np.nan, 0, 0], None)
    node.initial_pose_received(bad2, sim.t)
    np.testing.assert_array_equal(before, np.asarray(node.state.poses))


def test_pose_persistence_through_node(tmp_path):
    path = str(tmp_path / "saved_pose.yaml")
    sim, node = _mk(config_overrides={"save_pose": True, "saved_pose_filepath": path})
    _drive(sim, node, 10)
    node.shutdown(sim.t)
    # restart: a new node picks up the saved pose
    cfg2 = AMCLConfig.for_2d(save_pose=True, saved_pose_filepath=path,
                             max_particles=500)
    node2 = make_node(cfg2, tf_buffer=sim.tf)
    # the saved pose is TF-composed at the current odom (getLatestPose,
    # node.cpp:945-963), which is what the new node must restore exactly
    np.testing.assert_allclose(node2.init_pose, node.latest_pose.pose, atol=1e-6)
    # and it is close to the true pose (the robot was localized)
    np.testing.assert_allclose(node2.init_pose[:2], sim.true_pose[:2], atol=0.3)


@pytest.mark.slow
def test_reconfigure_rebuilds_filter():
    sim, node = _mk()
    _drive(sim, node, 6)
    new_cfg = node.config.replace(max_particles=300, min_particles=50)
    node.reconfigure(new_cfg)
    assert node.state.poses.shape[0] == 300
    # filter re-centered on the last published pose
    last = node.last_published_pose.pose
    mean = np.asarray(node.state.stats.mean)
    np.testing.assert_allclose(mean[:2], last[:2], atol=0.2)
    # keeps localizing after the rebuild
    _drive(sim, node, 8)
    exy, _ = _pose_err(sim, node)
    assert exy < 0.35


def test_watchdog():
    sim, node = _mk()
    _drive(sim, node, 2)
    assert node.check_scan_received(sim.t + 1.0) is None
    warning = node.check_scan_received(sim.t + 20.0)
    assert warning is not None and "No planar scan" in warning


def test_multi_scanner_registry():
    """Two scanner frames get independent extrinsics and update flags
    (node_2d.cpp:428-488)."""
    from badger_amcl.node.transforms import Transform

    sim, node = _mk()
    sim.tf.set_static("base_link", "laser2", Transform.from_xyzrpy(0.3, 0.0, 0.0))
    _drive(sim, node, 4)
    scan2 = sim.make_scan()
    scan2.frame_id = "laser2"
    node.scan_received(scan2)
    assert set(node.frame_to_scanner) == {"laser", "laser2"}
    assert len(node.scanner_params) == 2
    np.testing.assert_allclose(
        np.asarray(node.scanner_params[1].scanner_pose), [0.3, 0.0, 0.0], atol=1e-6
    )
