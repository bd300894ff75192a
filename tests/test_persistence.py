"""Pose persistence: YAML contract, on_exit covariance trust, NaN rejection,
legacy Python-YAML migration, atomic write."""

import math
import os

import numpy as np
import yaml

from badger_amcl.node.messages import (
    COVARIANCE_AA,
    COVARIANCE_XX,
    COVARIANCE_YY,
    PoseWithCovarianceStamped,
)
from badger_amcl.node.persistence import load_pose_from_file, save_pose_to_file

DEFAULT = (0.25, 0.25, (math.pi / 12) ** 2)


def _pose(x=1.5, y=-2.0, yaw=0.7, cov=(0.1, 0.2, 0.3)):
    return PoseWithCovarianceStamped.make(123.456, "map", [x, y, yaw], np.array(cov))


def test_roundtrip_on_exit(tmp_path):
    path = str(tmp_path / "pose.yaml")
    save_pose_to_file(path, _pose(), on_exit=True)
    out = load_pose_from_file(path, DEFAULT)
    assert out is not None
    pose, cov = out
    np.testing.assert_allclose(pose, [1.5, -2.0, 0.7], atol=1e-9)
    np.testing.assert_allclose(cov, [0.1, 0.2, 0.3], atol=1e-12)
    # file layout matches the reference contract
    doc = yaml.safe_load(open(path))
    assert doc["header"]["on_exit"] is True
    assert doc["header"]["frame_id"] == "map"
    assert doc["pose"]["pose"]["orientation"]["x"] == 0.0
    assert len(doc["pose"]["covariance"]) == 36


def test_covariance_untrusted_without_clean_exit(tmp_path):
    """on_exit False -> stored covariance replaced by defaults (node.cpp:540-551)."""
    path = str(tmp_path / "pose.yaml")
    save_pose_to_file(path, _pose(cov=(9.0, 9.0, 9.0)), on_exit=False)
    pose, cov = load_pose_from_file(path, DEFAULT)
    np.testing.assert_allclose(pose[:2], [1.5, -2.0])
    np.testing.assert_allclose(cov, DEFAULT)


def test_missing_on_exit_assumed_true(tmp_path):
    path = str(tmp_path / "pose.yaml")
    save_pose_to_file(path, _pose(cov=(0.4, 0.5, 0.6)), on_exit=True)
    doc = yaml.safe_load(open(path))
    del doc["header"]["on_exit"]
    yaml.safe_dump(doc, open(path, "w"))
    _, cov = load_pose_from_file(path, DEFAULT)
    np.testing.assert_allclose(cov, [0.4, 0.5, 0.6])


def test_nan_rejected(tmp_path):
    path = str(tmp_path / "pose.yaml")
    save_pose_to_file(path, _pose(), on_exit=True)
    doc = yaml.safe_load(open(path))
    doc["pose"]["pose"]["position"]["x"] = float("nan")
    yaml.safe_dump(doc, open(path, "w"))
    assert load_pose_from_file(path, DEFAULT) is None
    # invalid (all-zero) quaternion -> NaN yaw -> rejected
    save_pose_to_file(path, _pose(), on_exit=True)
    doc = yaml.safe_load(open(path))
    doc["pose"]["pose"]["orientation"]["z"] = 0.0
    doc["pose"]["pose"]["orientation"]["w"] = 0.0
    yaml.safe_dump(doc, open(path, "w"))
    # yaw of the zero quaternion is atan2(0, 1) = 0, not NaN — matches tf2,
    # so this still loads; a NaN quaternion must not:
    doc["pose"]["pose"]["orientation"]["w"] = float("nan")
    yaml.safe_dump(doc, open(path, "w"))
    assert load_pose_from_file(path, DEFAULT) is None


def test_legacy_python_yaml_migration(tmp_path):
    """The old Python-style `state:` nesting (node.cpp:555-606)."""
    cov = [0.0] * 36
    cov[COVARIANCE_XX] = 0.11
    cov[COVARIANCE_YY] = 0.22
    cov[COVARIANCE_AA] = 0.33
    legacy = {
        "state": [
            {"state": [0, 0, "map"]},
            {
                "state": [
                    {"state": [
                        {"state": [2.5, -1.0, 0.0]},           # position
                        {"state": [0.0, 0.0, math.sin(0.25), math.cos(0.25)]},  # quat
                    ]},
                    cov,
                ]
            },
        ]
    }
    path = str(tmp_path / "legacy.yaml")
    yaml.safe_dump(legacy, open(path, "w"))
    out = load_pose_from_file(path, DEFAULT)
    assert out is not None
    pose, cov3 = out
    np.testing.assert_allclose(pose, [2.5, -1.0, 0.5], atol=1e-9)
    np.testing.assert_allclose(cov3, [0.11, 0.22, 0.33])


def test_garbage_and_missing_files(tmp_path):
    assert load_pose_from_file(str(tmp_path / "nope.yaml"), DEFAULT) is None
    p = tmp_path / "garbage.yaml"
    p.write_text("not: [valid")
    assert load_pose_from_file(str(p), DEFAULT) is None
    p.write_text("unknownkey: 42")
    assert load_pose_from_file(str(p), DEFAULT) is None


def test_atomic_write_leaves_no_temp(tmp_path):
    path = str(tmp_path / "pose.yaml")
    save_pose_to_file(path, _pose(), on_exit=True)
    save_pose_to_file(path, _pose(x=9.0), on_exit=True)
    files = os.listdir(tmp_path)
    assert files == ["pose.yaml"]
    pose, _ = load_pose_from_file(path, DEFAULT)
    assert pose[0] == 9.0
