"""SE(3) transform utilities and the TransformBuffer."""

import math

import numpy as np
import pytest

from badger_amcl.node.transforms import (
    Transform,
    TransformBuffer,
    TransformLookupError,
    quat_from_rpy,
    quat_yaw,
)


def test_quat_yaw_roundtrip():
    for yaw in (-3.0, -1.2, 0.0, 0.7, 2.9):
        assert quat_yaw(quat_from_rpy(0, 0, yaw)) == pytest.approx(yaw, abs=1e-9)


def test_compose_inverse():
    a = Transform.from_xyzrpy(1.0, 2.0, 0.5, 0.1, -0.2, 0.9)
    b = Transform.from_xyzrpy(-0.3, 0.4, 0.0, 0.0, 0.3, -1.1)
    ab = a.compose(b)
    p = np.array([0.2, -0.7, 1.1])
    np.testing.assert_allclose(ab.apply(p), a.apply(b.apply(p)), atol=1e-9)
    ident = a.compose(a.inverse())
    np.testing.assert_allclose(ident.apply(p), p, atol=1e-9)


def test_upside_down_mount_flips_yaw():
    """A roll-pi extrinsic makes scanner yaw run backwards in the base frame —
    the case getAngleStats exists for (node_2d.cpp:497-532)."""
    import badger_amcl.node.scan_prep as sp
    from badger_amcl.node.messages import LaserScan

    scan = LaserScan(0.0, "laser", angle_min=-1.0, angle_increment=0.02,
                     range_min=0.1, range_max=10.0, ranges=np.ones(100))
    upright = Transform.from_xyzrpy(0, 0, 0, 0, 0, 0)
    amin, ainc = sp.angle_stats(scan, upright)
    assert amin == pytest.approx(-1.0) and ainc == pytest.approx(0.02)
    flipped = Transform.from_xyzrpy(0, 0, 0, math.pi, 0, 0)
    amin2, ainc2 = sp.angle_stats(scan, flipped)
    assert amin2 == pytest.approx(1.0) and ainc2 == pytest.approx(-0.02)


def test_buffer_static_timed_and_inverse():
    buf = TransformBuffer()
    buf.set_static("base", "laser", Transform.from_xyzrpy(0.2, 0.0, 0.1))
    np.testing.assert_allclose(
        buf.lookup("base", "laser").translation, [0.2, 0.0, 0.1]
    )
    # inverse direction resolves too
    np.testing.assert_allclose(
        buf.lookup("laser", "base").translation, [-0.2, 0.0, -0.1]
    )
    buf.set_transform("odom", "base", 0.0, Transform.from_pose2d([0, 0, 0]))
    buf.set_transform("odom", "base", 1.0, Transform.from_pose2d([1, 0, 0.2]))
    mid = buf.lookup("odom", "base", 0.5)
    np.testing.assert_allclose(mid.to_pose2d(), [0.5, 0.0, 0.1], atol=1e-3)
    # out-of-range clamps to endpoints
    np.testing.assert_allclose(buf.lookup("odom", "base", 5.0).to_pose2d(), [1, 0, 0.2], atol=1e-9)
    with pytest.raises(TransformLookupError):
        buf.lookup("map", "nowhere")


def test_range_clamping():
    import badger_amcl.node.scan_prep as sp
    from badger_amcl.node.messages import LaserScan

    scan = LaserScan(0.0, "laser", -1.0, 0.1, range_min=0.5, range_max=10.0,
                     ranges=np.array([0.2, 0.5, 3.0, 12.0]))
    ranges, rmax = sp.clamp_ranges(scan, laser_min_range=-1.0, laser_max_range=8.0)
    assert rmax == 8.0
    # short readings (<= range_min) map to range_max; long readings pass through
    np.testing.assert_allclose(ranges, [8.0, 8.0, 3.0, 12.0])


def test_decimation_strides():
    import badger_amcl.node.scan_prep as sp
    from badger_amcl.config import PlanarModelType

    # LF: step = (100-1)//(30-1) = 3 -> 34 beams (reference quirk: > max_beams)
    idx = sp.decimation_indices(100, 30, PlanarModelType.LIKELIHOOD_FIELD)
    assert idx[1] - idx[0] == 3 and len(idx) == 34
    # LF_PROB: step = ceil(100/30) = 4 -> 25 beams (<= max_beams)
    idx2 = sp.decimation_indices(100, 30, PlanarModelType.LIKELIHOOD_FIELD_PROB)
    assert idx2[1] - idx2[0] == 4 and len(idx2) == 25
