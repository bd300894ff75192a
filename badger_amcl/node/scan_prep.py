"""Host-side scan preprocessing: base-frame angles, range clamping, beam
decimation.

In the reference, decimation happens *inside* the sensor models
(planar_scanner.cpp:193,265,339,578) and angle/range prep in the node
(node_2d.cpp:497-560). We hoist decimation to the host so the device kernels
see static beam counts; the decimated index set is bit-identical to the
reference's loop strides.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from badger_amcl.config import PlanarModelType
from badger_amcl.node.messages import LaserScan
from badger_amcl.node.transforms import Transform, quat_from_rpy, quat_multiply, quat_yaw


def decimation_indices(range_count: int, max_beams: int, model: PlanarModelType) -> np.ndarray:
    """The exact per-model stride:

    - BEAM / LF / GOMPERTZ: step = (range_count-1)/(max_beams-1), min 1
      (planar_scanner.cpp:193,265,578 — integer division; note this can
      yield MORE than max_beams used beams, a reference quirk preserved)
    - LF_PROB: step = ceil(range_count / max_beams), min 1
      (planar_scanner.cpp:339)
    """
    if model == PlanarModelType.LIKELIHOOD_FIELD_PROB:
        step = max(1, math.ceil(range_count / float(max_beams)))
    else:
        step = max(1, (range_count - 1) // max(1, (max_beams - 1)))
    return np.arange(0, range_count, step)


def angle_stats(scan: LaserScan, base_to_scanner: Transform) -> Tuple[float, float]:
    """getAngleStats (node_2d.cpp:497-532): min/increment angles of the
    scanner re-expressed in the base frame, supporting upside-down mounts
    (a roll-pi extrinsic flips the increment sign)."""
    q_min = quat_from_rpy(0.0, 0.0, scan.angle_min)
    q_inc = quat_from_rpy(0.0, 0.0, scan.angle_min + scan.angle_increment)
    rot = base_to_scanner.rotation
    angle_min = quat_yaw(quat_multiply(rot, q_min))
    angle_inc = quat_yaw(quat_multiply(rot, q_inc)) - angle_min
    angle_inc = math.atan2(math.sin(angle_inc), math.cos(angle_inc))
    return angle_min, angle_inc


def clamp_ranges(scan: LaserScan, laser_min_range: float, laser_max_range: float):
    """updateLatestScanData (node_2d.cpp:534-560): user min/max thresholds;
    short readings map to max range (no min-range concept in AMCL)."""
    if laser_max_range > 0.0:
        range_max = min(scan.range_max, laser_max_range)
    else:
        range_max = scan.range_max
    if laser_min_range > 0.0:
        range_min = max(scan.range_min, laser_min_range)
    else:
        range_min = scan.range_min
    ranges = np.asarray(scan.ranges, np.float32).copy()
    ranges[ranges <= range_min] = range_max
    return ranges, float(range_max)


def prepare_scan(
    scan: LaserScan,
    base_to_scanner: Transform,
    laser_min_range: float,
    laser_max_range: float,
    max_beams: int,
    model: PlanarModelType,
):
    """Full 2D prep: clamp, base-frame angles, decimate. Returns
    (ranges (B,), angles (B,), range_max) as numpy."""
    ranges, range_max = clamp_ranges(scan, laser_min_range, laser_max_range)
    amin, ainc = angle_stats(scan, base_to_scanner)
    n = len(ranges)
    angles = amin + np.arange(n, dtype=np.float32) * np.float32(ainc)
    idx = decimation_indices(n, max_beams, model)
    return ranges[idx], angles[idx], range_max


def decimate_cloud(points: np.ndarray, max_beams: int) -> np.ndarray:
    """Cloud decimation (node_3d.cpp:467-480): step = (count-1)/(max_beams-1),
    min 1, then stride."""
    n = len(points)
    step = max(1, (n - 1) // max(1, (max_beams - 1)))
    return np.asarray(points)[np.arange(0, n, step)]
