"""Synthetic world harness.

The reference's de-facto integration spec is its example launch files plus
live robot data; it ships no simulator (SURVEY.md §4). This harness closes
that gap: a synthetic occupancy world, a scripted trajectory, raycast- or
distance-sampled sensor data, and simulated odometry (with drift/noise)
feeding the node layer exactly the messages a ROS bridge would.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from badger_amcl.maps.occupancy_2d import OccupancyMap2D
from badger_amcl.node.messages import LaserScan, OccupancyGrid, Odometry, PointCloud2
from badger_amcl.node.transforms import Transform, TransformBuffer
from badger_amcl.sensors.raycast import calc_range


def make_room_grid(n: int = 240, resolution: float = 0.05, n_pillars: int = 12,
                   seed: int = 42) -> OccupancyGrid:
    """An n x n cell room with border walls and random pillars, as an
    OccupancyGrid message (origin placed so the map is centered at 0,0 after
    the node's center-origin conversion)."""
    data = np.zeros((n, n), np.int8)
    data[0:2, :] = data[-2:, :] = 100
    data[:, 0:2] = data[:, -2:] = 100
    rng = np.random.default_rng(seed)
    for _ in range(n_pillars):
        cx, cy = rng.integers(n // 8, n - n // 8, 2)
        data[cy : cy + 8, cx : cx + 8] = 100
    return OccupancyGrid(
        width=n, height=n, resolution=resolution,
        origin_x=-n * resolution / 2.0, origin_y=-n * resolution / 2.0,
        data=data.ravel(),
    )


class Sim2D:
    """Drives a Node2D: true-pose kinematics, simulated odometry TF + topic,
    raycast laser scans."""

    def __init__(
        self,
        grid: OccupancyGrid,
        start_pose=(0.0, 0.0, 0.0),
        n_beams: int = 180,
        range_max: float = 8.0,
        range_noise: float = 0.01,
        odom_noise=(0.002, 0.002, 0.001),
        scanner_frame: str = "laser",
        scanner_mount: Optional[Transform] = None,
        base_frame: str = "base_link",
        seed: int = 1,
    ):
        self.grid = grid
        self.world = OccupancyMap2D.from_occupancy_grid_msg(
            grid.width, grid.height, grid.resolution, grid.origin_x, grid.origin_y,
            grid.data,
        )
        self.true_pose = np.asarray(start_pose, float).copy()
        self.odom_pose = self.true_pose.copy()  # odom frame == map at t=0
        self.n_beams = n_beams
        self.range_max = range_max
        self.range_noise = range_noise
        self.odom_noise = np.asarray(odom_noise)
        self.scanner_frame = scanner_frame
        self.scanner_mount = scanner_mount or Transform.identity()
        self.key = jax.random.PRNGKey(seed)
        self.t = 0.0
        self.base_frame = base_frame
        self.tf = TransformBuffer()
        self.tf.set_static(base_frame, scanner_frame, self.scanner_mount)
        self._beam_angles = jnp.linspace(
            -math.pi * 0.75, math.pi * 0.75, n_beams
        ).astype(jnp.float32)
        self._publish_odom_tf()

    def _next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def _publish_odom_tf(self):
        self.tf.set_transform(
            "odom", self.base_frame, self.t, Transform.from_pose2d(self.odom_pose)
        )

    def teleport(self, pose):
        """Kidnap the robot: the true pose jumps, odometry doesn't notice."""
        self.true_pose = np.asarray(pose, float).copy()

    def step(self, v: float, w: float, dt: float = 0.1):
        """Advance kinematics: unicycle model. Returns (odom_msg)."""
        self.t += dt
        self.true_pose[0] += v * dt * math.cos(self.true_pose[2])
        self.true_pose[1] += v * dt * math.sin(self.true_pose[2])
        self.true_pose[2] += w * dt
        noise = np.asarray(jax.random.normal(self._next_key(), (3,))) * self.odom_noise
        self.odom_pose[0] += v * dt * math.cos(self.odom_pose[2]) + noise[0]
        self.odom_pose[1] += v * dt * math.sin(self.odom_pose[2]) + noise[1]
        self.odom_pose[2] += w * dt + noise[2]
        self._publish_odom_tf()
        return Odometry(self.t, self.odom_pose.copy())

    def make_scan(self) -> LaserScan:
        """Raycast a scan from the true pose (through the scanner mount)."""
        mount = Transform.from_pose2d(self.true_pose).compose(self.scanner_mount)
        sx, sy, syaw = mount.to_pose2d()
        r = calc_range(
            self.world,
            jnp.float32(sx),
            jnp.float32(sy),
            jnp.float32(syaw) + self._beam_angles,
            self.range_max,
        )
        noise = self.range_noise * jax.random.normal(self._next_key(), (self.n_beams,))
        r = jnp.clip(r + noise, 0.0, self.range_max)
        amin = float(self._beam_angles[0])
        ainc = float(self._beam_angles[1] - self._beam_angles[0])
        return LaserScan(
            stamp=self.t, frame_id=self.scanner_frame,
            angle_min=amin, angle_increment=ainc,
            range_min=0.05, range_max=self.range_max,
            ranges=np.asarray(r),
        )


class Sim3D:
    """Drives a Node3D: a synthetic voxel world (walls + columns), point
    clouds sampled by projecting 2D raycasts to random heights."""

    def __init__(
        self,
        occupied_centers: np.ndarray,
        resolution: float,
        start_pose=(1.0, 1.0, 0.0),
        n_points: int = 256,
        scanner_frame: str = "lidar",
        scanner_mount: Optional[Transform] = None,
        noise: float = 0.01,
        odom_noise=(0.002, 0.002, 0.001),
        base_frame: str = "base_link",
        seed: int = 2,
    ):
        self.occupied = np.asarray(occupied_centers, float)
        self.resolution = resolution
        self.true_pose = np.asarray(start_pose, float).copy()
        self.odom_pose = self.true_pose.copy()
        self.n_points = n_points
        self.noise = noise
        self.odom_noise = np.asarray(odom_noise)
        self.scanner_frame = scanner_frame
        self.scanner_mount = scanner_mount or Transform.identity()
        self.key = jax.random.PRNGKey(seed)
        self.t = 0.0
        self.base_frame = base_frame
        self.tf = TransformBuffer()
        self.tf.set_static(base_frame, scanner_frame, self.scanner_mount)
        self._publish_odom_tf()

    def _next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def _publish_odom_tf(self):
        self.tf.set_transform(
            "odom", self.base_frame, self.t, Transform.from_pose2d(self.odom_pose)
        )

    def step(self, v: float, w: float, dt: float = 0.1):
        self.t += dt
        self.true_pose[0] += v * dt * math.cos(self.true_pose[2])
        self.true_pose[1] += v * dt * math.sin(self.true_pose[2])
        self.true_pose[2] += w * dt
        noise = np.asarray(jax.random.normal(self._next_key(), (3,))) * self.odom_noise
        self.odom_pose[0] += v * dt * math.cos(self.odom_pose[2]) + noise[0]
        self.odom_pose[1] += v * dt * math.sin(self.odom_pose[2]) + noise[1]
        self.odom_pose[2] += w * dt + noise[2]
        self._publish_odom_tf()
        return Odometry(self.t, self.odom_pose.copy())

    def make_cloud(self) -> PointCloud2:
        """Sample surface points from the occupied set visible-ish from the
        true pose, expressed in the scanner frame."""
        k1, k2 = jax.random.split(self._next_key())
        idx = np.asarray(
            jax.random.randint(k1, (self.n_points,), 0, len(self.occupied))
        )
        pts_world = self.occupied[idx] + np.asarray(
            jax.random.normal(k2, (self.n_points, 3))
        ) * self.noise
        t_map_scanner = Transform.from_pose2d(self.true_pose).compose(self.scanner_mount)
        pts_scanner = t_map_scanner.inverse().apply(pts_world)
        return PointCloud2(stamp=self.t, frame_id=self.scanner_frame, points=pts_scanner)
