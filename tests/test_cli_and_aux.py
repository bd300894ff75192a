"""CLI entry point, YAML config loading, full-state checkpoint, replay
driver, ROS bridge translation helpers, octomap LUT debug cloud, profiling."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np

from badger_amcl import cli
from badger_amcl.config import AMCLConfig, OdomModelType, PlanarModelType
from badger_amcl.node import checkpoint, ros_bridge
from badger_amcl.pf import PFParams, init_with_gaussian
from badger_amcl.utils.profiling import PhaseTimer
import pytest


def test_yaml_config_load(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text(
        "map_type: 2\nmax_particles: 1234\nodom_model_type: gaussian\n"
        "laser_model_type: likelihood_field_gompertz\nbogus_key: 7\n"
    )
    cfg = cli.load_config(str(p))
    assert cfg.max_particles == 1234
    assert cfg.odom_model_type == OdomModelType.GAUSSIAN
    assert cfg.laser_model_type == PlanarModelType.LIKELIHOOD_FIELD_GOMPERTZ


def test_reference_param_spellings_load_unmodified():
    """A reference 2D launch file's param dict loads 1:1: the exact rosparam
    spellings (node_2d.cpp:66-77 incl. the beam_skip_error_threshold_
    trailing-underscore quirk at :73, node_3d.cpp:73-77) map onto our fields
    and declared-but-unread params are accepted silently."""
    warnings = []
    cfg = AMCLConfig.from_params(
        {
            "laser_scanner_off_map_factor": 0.7,
            "laser_scanner_non_free_space_factor": 0.6,
            "laser_scanner_non_free_space_radius": 0.4,
            "global_localization_planar_off_map_factor": 0.2,
            "global_localization_planar_non_free_space_factor": 0.3,
            "global_localization_scanner_off_map_factor": 0.25,
            "beam_skip_error_threshold_": 0.8,
            "gui_publish_rate": 10.0,  # declared-but-never-read (node.cpp)
            "use_map_topic": True,
            "off_object_penalty_factor": 1.0,
        },
        warn=lambda *a: warnings.append(a),
    )
    assert cfg.laser_off_map_factor == 0.7
    assert cfg.laser_non_free_space_factor == 0.6
    assert cfg.laser_non_free_space_radius == 0.4
    # later alias spelling wins for the shared field (dict order)
    assert cfg.global_localization_laser_off_map_factor == 0.25
    assert cfg.global_localization_laser_non_free_space_factor == 0.3
    assert cfg.beam_skip_error_threshold == 0.8
    assert warnings == []


@pytest.mark.slow
def test_reconfigure_restore_defaults():
    """restore_defaults reverts to the construction snapshot
    (node.cpp:192-206)."""
    from badger_amcl.node.node_2d import Node2D

    cfg = AMCLConfig.for_2d(min_particles=20, max_particles=80)
    node = Node2D(cfg)
    node.reconfigure(cfg.replace(max_particles=500, laser_z_hit=0.5))
    assert node.config.max_particles == 500
    node.reconfigure(restore_defaults=True)
    assert node.config.max_particles == 80
    assert node.config.laser_z_hit == cfg.laser_z_hit
    assert node.params.max_samples == 80


@pytest.mark.slow
def test_cli_sim_smoke(tmp_path):
    rc = cli.main([
        "--sim", "--steps", "12", "--seed", "0",
        "--config", "/dev/null",
    ])
    assert rc == 0


def test_cli_replay(tmp_path):
    """Drive the node through a JSONL replay log."""
    grid_n = 60
    data = np.zeros((grid_n, grid_n), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = 100
    lines = [
        {"topic": "tf_static", "parent": "base_link", "child": "laser",
         "pose": [0.0, 0.0, 0.0], "stamp": 0.0},
        {"topic": "map", "width": grid_n, "height": grid_n, "resolution": 0.1,
         "origin_x": -3.0, "origin_y": -3.0, "data": data.ravel().tolist(),
         "stamp": 0.0},
    ]
    b = 30
    angles = np.linspace(-1.5, 1.5, b)
    for k in range(6):
        t = 0.1 * (k + 1)
        lines.append({"topic": "tf", "parent": "odom", "child": "base_link",
                      "pose": [0.05 * k, 0.0, 0.0], "stamp": t})
        lines.append({"topic": "odom", "pose": [0.05 * k, 0.0, 0.0], "stamp": t})
        lines.append({
            "topic": "scan", "frame_id": "laser", "stamp": t,
            "angle_min": float(angles[0]),
            "angle_increment": float(angles[1] - angles[0]),
            "range_max": 8.0,
            "ranges": np.full(b, 2.5).tolist(),
        })
    log = tmp_path / "run.jsonl"
    log.write_text("\n".join(json.dumps(x) for x in lines))
    rc = cli.main(["--replay", str(log), "--seed", "1", "--config", "/dev/null"])
    assert rc == 0


def test_checkpoint_roundtrip(tmp_path):
    params = PFParams(min_samples=10, max_samples=200)
    st = init_with_gaussian(
        params, jax.random.PRNGKey(0), jnp.array([1.0, 2.0, 0.3]),
        jnp.diag(jnp.array([0.1, 0.1, 0.02])),
    )
    st = st.replace(w_slow=jnp.float32(0.3), w_fast=jnp.float32(0.4))
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, st)
    back = checkpoint.load_state(path, params)
    assert back is not None
    np.testing.assert_array_equal(np.asarray(back.poses), np.asarray(st.poses))
    np.testing.assert_array_equal(np.asarray(back.weights), np.asarray(st.weights))
    assert float(back.w_slow) == float(np.float32(0.3))
    assert float(back.w_fast) == float(np.float32(0.4))
    # PRNG continuity: next keys match
    k1 = jax.random.split(st.key)[0]
    k2 = jax.random.split(back.key)[0]
    np.testing.assert_array_equal(jax.random.key_data(k1), jax.random.key_data(k2))
    # capacity mismatch -> refused
    assert checkpoint.load_state(path, PFParams(max_samples=100)) is None
    # corrupt file -> refused
    (tmp_path / "junk.npz").write_bytes(b"not a zip")
    assert checkpoint.load_state(str(tmp_path / "junk.npz"), params) is None


def _ros_stamp(t):
    return types.SimpleNamespace(to_sec=lambda: t)


def test_ros_bridge_translations():
    scan = types.SimpleNamespace(
        header=types.SimpleNamespace(stamp=_ros_stamp(1.5), frame_id="laser"),
        angle_min=-1.0, angle_increment=0.01, range_min=0.1, range_max=10.0,
        ranges=[1.0, 2.0, 3.0],
    )
    out = ros_bridge.laser_scan_from_ros(scan)
    assert out.stamp == 1.5 and out.frame_id == "laser"
    np.testing.assert_allclose(out.ranges, [1, 2, 3])

    grid = types.SimpleNamespace(
        info=types.SimpleNamespace(
            width=4, height=2, resolution=0.1,
            origin=types.SimpleNamespace(position=types.SimpleNamespace(x=-1.0, y=2.0)),
        ),
        data=list(range(8)),
    )
    g = ros_bridge.occupancy_grid_from_ros(grid)
    assert (g.width, g.height, g.origin_x, g.origin_y) == (4, 2, -1.0, 2.0)

    import math
    q = types.SimpleNamespace(x=0.0, y=0.0, z=math.sin(0.35), w=math.cos(0.35))
    odom = types.SimpleNamespace(
        header=types.SimpleNamespace(stamp=_ros_stamp(2.0)),
        pose=types.SimpleNamespace(pose=types.SimpleNamespace(
            position=types.SimpleNamespace(x=3.0, y=4.0), orientation=q,
        )),
    )
    o = ros_bridge.odometry_from_ros(odom)
    np.testing.assert_allclose(o.pose, [3.0, 4.0, 0.7], atol=1e-9)


def test_octomap_lut_debug_cloud():
    from badger_amcl.maps import OctoMap3D

    pts = np.array([[0.5, 0.5, 0.5]])
    m = OctoMap3D.from_occupied_points(
        pts, 0.1, 0.3, metric_min=(0, 0, 0), metric_max=(1.0, 1.0, 1.0)
    ).with_distance_field()
    cloud = m.distances_lut_cloud()
    assert cloud.shape[1] == 4
    assert (cloud[:, 3] < 0.3).all()
    # the occupied voxel itself is present with distance 0
    at_occ = cloud[np.all(np.isclose(cloud[:, :3], 0.5), axis=1)]
    assert len(at_occ) == 1 and at_occ[0, 3] == 0.0


def test_phase_timer():
    t = PhaseTimer()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    rep = t.report()
    assert rep["a"]["count"] == 2
    assert rep["a"]["mean_ms"] >= 0.0
