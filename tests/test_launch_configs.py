"""The shipped launch configs are the tested configs.

The reference ships two production configs (examples/badger_amcl_2d.launch,
examples/badger_amcl_3d.launch). `examples/amcl_2d.yaml` / `amcl_3d.yaml`
mirror them param-for-param; these tests pin that:

- both mirrors load through `AMCLConfig.from_params` with ZERO warnings
  (every launch spelling is either a field, an alias, or a documented
  declared-but-unread param);
- when the reference tree is available, the mirror is compared key-by-key
  against the parsed launch XML (same keys, same values, rosparam
  last-wins duplicate handling);
- the resolved config sits at the production operating point (systematic
  resampling, 2x supersampled map, base_footprint);
- an E2E run at that operating point localizes.
"""

import math
import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import yaml

from badger_amcl.config import AMCLConfig, ResampleModelType, PlanarModelType

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
REF_EXAMPLES = "/root/reference/examples"


def _load_yaml(name):
    with open(os.path.join(EXAMPLES, name)) as f:
        return yaml.safe_load(f)


def _from_params_strict(raw):
    warnings = []
    cfg = AMCLConfig.from_params(raw, warn=lambda msg, *a: warnings.append(msg % a))
    return cfg, warnings


def _parse_launch(path):
    """Launch XML -> {param: string value}, resolving $(arg x) to the arg's
    default and applying rosparam's last-wins for duplicated params (the 3D
    launch sets odom_alpha4 twice)."""
    root = ET.parse(path).getroot()
    args = {a.get("name"): a.get("default", "") for a in root.iter("arg")}
    params = {}
    for p in root.iter("param"):
        v = p.get("value")
        if v.startswith("$(arg ") and v.endswith(")"):
            v = args[v[6:-1]]
        params[p.get("name")] = v  # dict insert: last one wins
    return params


def _coerce_eq(yaml_v, launch_v):
    if isinstance(yaml_v, bool):
        return str(yaml_v).lower() == str(launch_v).strip().lower()
    try:
        return math.isclose(float(yaml_v), float(launch_v), rel_tol=0, abs_tol=0)
    except (TypeError, ValueError):
        return str(yaml_v) == str(launch_v)


# ---------------------------------------------------------------- load clean


def test_launch_2d_mirror_loads_warning_free():
    cfg, warnings = _from_params_strict(_load_yaml("amcl_2d.yaml"))
    assert warnings == []
    assert cfg.map_type == 2


def test_launch_3d_mirror_loads_warning_free():
    """Includes the global_localization_point_cloud_scanner_* spellings the
    launch sets but the reference code never reads (node_3d.cpp:75-77 reads
    global_localization_scanner_*) — they must load silently, as there."""
    cfg, warnings = _from_params_strict(_load_yaml("amcl_3d.yaml"))
    assert warnings == []
    assert cfg.map_type == 3


# ------------------------------------------------------------- XML crosswalk


@pytest.mark.parametrize(
    "yaml_name,launch_name",
    [("amcl_2d.yaml", "badger_amcl_2d.launch"),
     ("amcl_3d.yaml", "badger_amcl_3d.launch")],
)
def test_yaml_mirrors_launch_xml(yaml_name, launch_name):
    launch_path = os.path.join(REF_EXAMPLES, launch_name)
    if not os.path.exists(launch_path):
        pytest.skip("reference launch files not available")
    launch = _parse_launch(launch_path)
    ours = _load_yaml(yaml_name)
    missing = set(launch) - set(ours)
    extra = set(ours) - set(launch)
    assert not missing, f"yaml missing launch params: {sorted(missing)}"
    assert not extra, f"yaml has params the launch does not set: {sorted(extra)}"
    diffs = {k: (ours[k], launch[k]) for k in launch
             if not _coerce_eq(ours[k], launch[k])}
    assert not diffs, f"value mismatches (yaml, launch): {diffs}"


# ------------------------------------------------------ operating-point pins


def test_2d_production_operating_point():
    cfg, _ = _from_params_strict(_load_yaml("amcl_2d.yaml"))
    assert cfg.resample_model_type is ResampleModelType.SYSTEMATIC
    assert cfg.map_scale_up_factor == 2
    assert cfg.base_frame_id == "base_footprint"
    assert cfg.laser_model_type is PlanarModelType.LIKELIHOOD_FIELD_GOMPERTZ
    assert cfg.transform_tolerance == 2.0
    assert cfg.recovery_alpha_slow == 0.0 and cfg.recovery_alpha_fast == 0.0
    assert (cfg.min_particles, cfg.max_particles) == (2000, 8000)


def test_3d_production_operating_point():
    cfg, _ = _from_params_strict(_load_yaml("amcl_3d.yaml"))
    assert cfg.resample_model_type is ResampleModelType.SYSTEMATIC
    assert cfg.base_frame_id == "base_footprint"
    # rosparam last-wins on the duplicated odom_alpha4 line
    # (badger_amcl_3d.launch:31-32): final value 0.015, alpha5 stays default
    assert cfg.odom_alpha4 == 0.015
    assert cfg.laser_max_beams == 128
    assert cfg.resolved_cloud_max_beams == 128
    assert (cfg.min_particles, cfg.max_particles) == (1000, 10000)


# --------------------------------------------------------------- E2E at the
# production operating point: systematic resampling ON a 2x-supersampled map
# with the launch's gaussian odom + gompertz measurement constants.


@pytest.mark.slow
def test_e2e_on_shipped_2d_config():
    from badger_amcl.node import make_node
    from badger_amcl.sim import Sim2D, make_room_grid

    cfg, warnings = _from_params_strict(_load_yaml("amcl_2d.yaml"))
    assert warnings == []
    # sim-scale overrides ONLY (cloud size / cadence / save path); every
    # model, resample, and map parameter stays exactly as the launch sets it
    cfg = cfg.replace(
        min_particles=150, max_particles=1200,
        update_min_d=0.05, update_min_a=0.05, save_pose=False,
    )
    grid = make_room_grid(n=140, resolution=0.09, n_pillars=6)
    # the launch names the robot base base_footprint; the sim publishes its
    # TFs under whatever the base frame is called
    sim = Sim2D(grid, start_pose=(-2.5, -2.5, 0.2), n_beams=100,
                base_frame="base_footprint")
    node = make_node(cfg, tf_buffer=sim.tf)
    node.init_pose = np.array([-2.5, -2.5, 0.2])
    node.init_cov = np.array([0.2, 0.2, 0.05])
    node.map_msg_received(grid)
    assert node.map.resolution == pytest.approx(0.045)  # scale-up happened
    for _ in range(22):
        odom = sim.step(0.3, 0.15)
        node.integrate_odom(odom)
        node.scan_received(sim.make_scan())
    _, est = node.get_max_weight_pose()
    err = math.hypot(est[0] - sim.true_pose[0], est[1] - sim.true_pose[1])
    assert err < 0.3
