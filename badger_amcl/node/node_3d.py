"""3D localization node: point-cloud pipeline.

Host-shim re-design of the reference's `Node3D` (src/amcl/node/node_3d.cpp):
octomap ingestion to a voxel EDT (optionally deferred until the 2D occupancy
map provides crop bounds), cloud decimation, per-frame-id scanner registry
with footprint extrinsics, the same resample/argmax/watchdog structure as 2D.
"""

from __future__ import annotations

import functools
import logging
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from badger_amcl.config import AMCLConfig
from badger_amcl.maps.octomap_3d import OctoMap3D
from badger_amcl.maps.octree_io import read_bt, read_ot
from badger_amcl.node import scan_prep
from badger_amcl.node.messages import OccupancyGrid, OctomapMsg, PointCloud2
from badger_amcl.node.node import Node
from badger_amcl.node.transforms import Transform, TransformLookupError
from badger_amcl.pf import filter as pf_filter
from badger_amcl.sensors.point_cloud import (
    PointCloudParams,
    point_cloud_likelihood,
)

log = logging.getLogger("badger_amcl")

SCAN_WATCHDOG_INTERVAL = 15.0  # node_3d.cpp:102-105


@functools.partial(jax.jit, static_argnames=("model",))
def _sensor_update_jit(state, omap, params, points_base, model):
    p, mf = point_cloud_likelihood(omap, params, points_base, state.poses, model)
    return pf_filter.sensor_update(state, p, mf)


@functools.partial(jax.jit, static_argnames=("model",))
def _score_poses_jit(omap, params, points_base, poses, model):
    p, mf = point_cloud_likelihood(omap, params, points_base, poses, model)
    return p * mf


class Node3D(Node):
    def __init__(self, config: AMCLConfig, tf_buffer=None, seed: int = 0):
        super().__init__(config, tf_buffer, seed)
        self.map: Optional[OctoMap3D] = None
        self.first_octomap_received = False
        self.first_occupancy_map_received = False
        self.occupancy_bounds_received = False
        self.occupancy_map_min = None
        self.occupancy_map_max = None
        self.latest_points_base: Optional[jnp.ndarray] = None
        self.latest_scan_received_ts: Optional[float] = None
        self.frame_to_scanner: Dict[str, int] = {}
        self.scanner_tfs: List[Transform] = []
        self.scanners_update: List[bool] = []
        self.pc_params = self._make_params()

    # --------------------------------------------------------------- params

    def _make_params(self) -> PointCloudParams:
        cfg = self.config
        return PointCloudParams(
            z_hit=jnp.float32(cfg.laser_z_hit),
            z_rand=jnp.float32(cfg.laser_z_rand),
            sigma_hit=jnp.float32(cfg.laser_sigma_hit),
            gompertz_a=jnp.float32(cfg.laser_gompertz_a),
            gompertz_b=jnp.float32(cfg.laser_gompertz_b),
            gompertz_c=jnp.float32(cfg.laser_gompertz_c),
            input_shift=jnp.float32(cfg.laser_gompertz_input_shift),
            input_scale=jnp.float32(cfg.laser_gompertz_input_scale),
            output_shift=jnp.float32(cfg.laser_gompertz_output_shift),
            off_map_factor=jnp.float32(cfg.laser_off_map_factor),
            non_free_space_factor=jnp.float32(cfg.laser_non_free_space_factor),
            non_free_space_radius=jnp.float32(cfg.laser_non_free_space_radius),
        )

    def _apply_normal_factors(self):
        cfg = self.config
        self.pc_params = self.pc_params.replace(
            off_map_factor=jnp.float32(cfg.laser_off_map_factor),
            non_free_space_factor=jnp.float32(cfg.laser_non_free_space_factor),
            non_free_space_radius=jnp.float32(cfg.laser_non_free_space_radius),
        )

    def _apply_global_localization_factors(self):
        cfg = self.config
        self.pc_params = self.pc_params.replace(
            off_map_factor=jnp.float32(cfg.global_localization_laser_off_map_factor),
            non_free_space_factor=jnp.float32(
                cfg.global_localization_laser_non_free_space_factor
            ),
        )

    def _reconfigure_sensors(self):
        self.pc_params = self._make_params()

    # ------------------------------------------------------------------ maps

    def octomap_msg_received(self, msg: OctomapMsg) -> None:
        """octoMapMsgReceived (node_3d.cpp:199-218) + initFromNewMap
        (:220-256): build the OctoMap, bake the EDT now or defer until the
        occupancy map bounds arrive."""
        if self.config.first_map_only and self.first_octomap_received:
            return
        log.info("Received a new Octomap")
        max_dist = self.config.resolved_cloud_likelihood_max_dist
        if msg.binary_data is not None:
            tree = read_bt(msg.binary_data)
            omap = OctoMap3D.from_binary_octree(tree, max_dist)
        elif msg.full_data is not None:
            # fullMsgToMap branch (node_3d.cpp:270-273): full probabilistic
            # tree, leaves thresholded at logodds>0
            tree = read_ot(msg.full_data)
            omap = OctoMap3D.from_binary_octree(tree, max_dist)
        else:
            omap = OctoMap3D.from_occupied_points(
                msg.occupied_centers, msg.resolution, max_dist
            )
        self.frame_to_scanner.clear()
        self.scanner_tfs = []
        self.scanners_update = []
        self.latest_points_base = None
        self.init_from_new_map(omap, use_initial_pose=not self.first_octomap_received)
        if self.config.wait_for_occupancy_map and self.occupancy_bounds_received:
            self.map = self.map.set_map_bounds(self.occupancy_map_min, self.occupancy_map_max)
            self._update_free_space_indices()
        elif not self.config.wait_for_occupancy_map:
            self.map = self.map.with_distance_field()
            self._update_free_space_indices()
        self.first_octomap_received = True

    def occupancy_map_msg_received(self, msg: OccupancyGrid) -> None:
        """occupancyMapMsgReceived (node_3d.cpp:178-197): the 2D map supplies
        crop bounds for the voxel EDT."""
        cfg = self.config
        if not cfg.wait_for_occupancy_map or (
            cfg.first_map_only and self.first_occupancy_map_received
        ):
            return
        self.first_occupancy_map_received = True
        s = cfg.map_scale_up_factor
        resolution = msg.resolution / s
        w, h = msg.width * s, msg.height * s
        # Reference quirk preserved: the min bound is hard-coded {0.0, 0.0}
        # and the grid's origin is ignored entirely (node_3d.cpp:189-190
        # uses only width*res / height*res). A non-zero-origin grid therefore
        # crops the same world window as a zero-origin one; setMapBounds then
        # pads by max_distance_to_object and intersects with the octree's own
        # extent (octomap.cpp:128-150), which bounds the damage in practice.
        self.occupancy_map_min = [0.0, 0.0]
        self.occupancy_map_max = [w * resolution, h * resolution]
        self.occupancy_bounds_received = True
        if self.first_octomap_received:
            self.map = self.map.set_map_bounds(self.occupancy_map_min, self.occupancy_map_max)
            self._update_free_space_indices()

    def _update_free_space_indices(self):
        """updateFreeSpaceIndices (node_3d.cpp:306-318): all in-bounds (i, j);
        3D maps use the zero-origin convention (world = cell * res)."""
        fsi = self.map.free_space_indices()
        self.update_free_space_indices(
            fsi, np.zeros(2), np.zeros(2, np.int32), self.map.resolution
        )

    # ------------------------------------------------------------- scanners

    def _get_scanner_index(self, frame_id: str) -> int:
        """getFrameToScannerIndex (node_3d.cpp:400-451): full SE(3) footprint
        extrinsic per frame."""
        if frame_id in self.frame_to_scanner:
            return self.frame_to_scanner[frame_id]
        try:
            tf = self.tf.lookup(self.config.base_frame_id, frame_id)
        except TransformLookupError:
            log.error("Failed to get transform from base footprint to %s", frame_id)
            return -1
        idx = len(self.scanner_tfs)
        self.scanner_tfs.append(tf)
        self.scanners_update.append(True)
        self.frame_to_scanner[frame_id] = idx
        return idx

    # ------------------------------------------------------------- pipeline

    def _is_map_initialized(self) -> bool:
        return (
            self.map is not None
            and self.state is not None
            and self.map.distances_lut_created
        )

    def scan_received(self, cloud: PointCloud2, now: Optional[float] = None) -> None:
        """scanReceived (node_3d.cpp:320-340)."""
        now = cloud.stamp if now is None else now
        self.latest_scan_received_ts = now
        if not self._is_map_initialized():
            return
        if not self.global_localization_active:
            self.deactivate_global_localization_params()
        scanner_index = self._get_scanner_index(cloud.frame_id)
        if scanner_index < 0:
            return
        success, force_publication = self.update_pf(
            cloud.stamp, self.scanners_update, scanner_index
        )
        resampled = False
        if success and self.scanners_update[scanner_index]:
            resampled = self._update_scanner(cloud, scanner_index)
        if success and (force_publication or resampled):
            self.resample_pose(cloud.stamp)

    def _update_scanner(self, cloud: PointCloud2, scanner_index: int) -> bool:
        """updateScanner (node_3d.cpp:348-365): decimate to max_beams points
        (:467-480), fold the scanner->footprint extrinsic into the cloud once
        (the reference redoes this per particle in getMapCloud — the single
        most expensive construct it has, SURVEY.md §3.2)."""
        cfg = self.config
        pts = scan_prep.decimate_cloud(cloud.points, cfg.resolved_cloud_max_beams)
        pts_base = self.scanner_tfs[scanner_index].apply(pts)
        self.latest_points_base = jnp.asarray(pts_base, jnp.float32)
        with self.timers.phase("sensor_update"):
            self.state = _sensor_update_jit(
                self.state, self.map, self.pc_params, self.latest_points_base,
                cfg.point_cloud_model_type.value,
            )
        self.scanners_update[scanner_index] = False
        self.resample_count += 1
        resampled = False
        if self.resample_count % cfg.resample_interval == 0:
            self.resample_particles()
            resampled = True
        if not self.force_update:
            self.publish_particle_cloud(cloud.stamp)
        return resampled

    # ------------------------------------------------------------- scoring

    def score_poses(self, poses: jnp.ndarray) -> jnp.ndarray:
        """scorePose batched (node_3d.cpp:286-304)."""
        if self.latest_points_base is None:
            return jnp.ones((poses.shape[0],), jnp.float32)
        return _score_poses_jit(
            self.map, self.pc_params, self.latest_points_base, poses,
            self.config.point_cloud_model_type.value,
        )

    # ------------------------------------------------------------- watchdog

    def check_scan_received(self, now: float) -> Optional[str]:
        """checkScanReceived (node_3d.cpp:542-550)."""
        if self.latest_scan_received_ts is None:
            return None
        d = now - self.latest_scan_received_ts
        if d > SCAN_WATCHDOG_INTERVAL:
            msg = f"No point cloud scan received for {d:.1f} seconds."
            log.warning(msg)
            return msg
        return None
