"""2D localization node: laser-scan pipeline.

Host-shim re-design of the reference's `Node2D` (src/amcl/node/node_2d.cpp):
map conversion with supersampling, per-frame-id multi-scanner registry with
lazily-resolved extrinsics, base-frame angle recomputation (upside-down
mounts), range clamping, resample cadence, cluster-argmax pose extraction,
free-space index maintenance, scan watchdog, global-localization factor
overrides, and pose scoring for the uniform pose generator.
"""

from __future__ import annotations

import functools
import logging
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from badger_amcl.config import AMCLConfig
from badger_amcl.maps.occupancy_2d import OccupancyMap2D
from badger_amcl.node import scan_prep
from badger_amcl.node.messages import LaserScan, OccupancyGrid
from badger_amcl.node.node import Node
from badger_amcl.node.transforms import TransformLookupError
from badger_amcl.pf import filter as pf_filter
from badger_amcl.sensors.planar import (
    PlanarScan,
    PlanarScanParams,
    planar_likelihood,
)

log = logging.getLogger("badger_amcl")

SCAN_WATCHDOG_INTERVAL = 15.0  # node_2d.cpp:107-110


@functools.partial(jax.jit, static_argnames=("model", "do_beamskip", "log_space"))
def _sensor_update_jit(state, omap, params, scan, model, do_beamskip,
                       log_space=False):
    p, mf = planar_likelihood(
        omap, params, scan, state.poses, state.active_mask, state.n_active,
        model, converged=state.converged, do_beamskip=do_beamskip,
        prob_log_space=log_space,
    )
    if log_space:  # likelihood_field_prob log-space pipeline (config knob)
        return pf_filter.sensor_update_log(state, p, mf)
    return pf_filter.sensor_update(state, p, mf)


@functools.partial(jax.jit, static_argnames=("model",))
def _score_poses_jit(omap, params, scan, poses, model):
    n = poses.shape[0]
    p, mf = planar_likelihood(
        omap, params, scan, poses, jnp.ones((n,), bool), jnp.int32(n),
        model, converged=jnp.array(False), do_beamskip=False,
    )
    # fake 1-weight sample through the full model (scorePose)
    return p * mf


class Node2D(Node):
    def __init__(self, config: AMCLConfig, tf_buffer=None, seed: int = 0):
        super().__init__(config, tf_buffer, seed)
        self.map: Optional[OccupancyMap2D] = None
        self.first_map_received = False
        self.latest_scan: Optional[PlanarScan] = None
        self.latest_scan_received_ts: Optional[float] = None
        # multi-scanner registry (node_2d.cpp:428-488)
        self.frame_to_scanner: Dict[str, int] = {}
        self.scanner_params: List[PlanarScanParams] = []
        self.scanners_update: List[bool] = []
        self._base_params = self._make_params()

    # --------------------------------------------------------------- params

    def _make_params(self, scanner_pose=None) -> PlanarScanParams:
        cfg = self.config
        kw = dict(
            z_hit=jnp.float32(cfg.laser_z_hit),
            z_short=jnp.float32(cfg.laser_z_short),
            z_max=jnp.float32(cfg.laser_z_max),
            z_rand=jnp.float32(cfg.laser_z_rand),
            sigma_hit=jnp.float32(cfg.laser_sigma_hit),
            lambda_short=jnp.float32(cfg.laser_lambda_short),
            gompertz_a=jnp.float32(cfg.laser_gompertz_a),
            gompertz_b=jnp.float32(cfg.laser_gompertz_b),
            gompertz_c=jnp.float32(cfg.laser_gompertz_c),
            input_shift=jnp.float32(cfg.laser_gompertz_input_shift),
            input_scale=jnp.float32(cfg.laser_gompertz_input_scale),
            output_shift=jnp.float32(cfg.laser_gompertz_output_shift),
            off_map_factor=jnp.float32(cfg.laser_off_map_factor),
            non_free_space_factor=jnp.float32(cfg.laser_non_free_space_factor),
            non_free_space_radius=jnp.float32(cfg.laser_non_free_space_radius),
            beam_skip_distance=jnp.float32(cfg.beam_skip_distance),
            beam_skip_threshold=jnp.float32(cfg.beam_skip_threshold),
            beam_skip_error_threshold=jnp.float32(cfg.beam_skip_error_threshold),
        )
        if scanner_pose is not None:
            kw["scanner_pose"] = jnp.asarray(scanner_pose, jnp.float32)
        return PlanarScanParams(**kw)

    def _set_map_factors(self, off_map, non_free, radius):
        """setMapFactors on every scanner (node_2d.cpp:420-425,631-639)."""
        self.scanner_params = [
            p.replace(
                off_map_factor=jnp.float32(off_map),
                non_free_space_factor=jnp.float32(non_free),
                non_free_space_radius=jnp.float32(radius),
            )
            for p in self.scanner_params
        ]
        self._base_params = self._base_params.replace(
            off_map_factor=jnp.float32(off_map),
            non_free_space_factor=jnp.float32(non_free),
            non_free_space_radius=jnp.float32(radius),
        )

    def _apply_normal_factors(self):
        cfg = self.config
        self._set_map_factors(
            cfg.laser_off_map_factor,
            cfg.laser_non_free_space_factor,
            cfg.laser_non_free_space_radius,
        )

    def _apply_global_localization_factors(self):
        cfg = self.config
        self._set_map_factors(
            cfg.global_localization_laser_off_map_factor,
            cfg.global_localization_laser_non_free_space_factor,
            cfg.laser_non_free_space_radius,
        )

    def _reconfigure_sensors(self):
        pose_bak = [p.scanner_pose for p in self.scanner_params]
        self._base_params = self._make_params()
        self.scanner_params = [self._make_params(sp) for sp in pose_bak]

    # ------------------------------------------------------------------ map

    def map_msg_received(self, msg: OccupancyGrid) -> None:
        """mapMsgReceived (node_2d.cpp:202-221) + initFromNewMap (:223-259)."""
        if self.config.first_map_only and self.first_map_received:
            return
        log.info(
            "Received a %d X %d occupancy map @ %.3f m/pix",
            msg.width, msg.height, msg.resolution,
        )
        omap = OccupancyMap2D.from_occupancy_grid_msg(
            msg.width, msg.height, msg.resolution, msg.origin_x, msg.origin_y,
            msg.data, self.config.map_scale_up_factor,
        )
        # the LF-family models bake the distance LUT at model setup
        # (setModelLikelihoodField*, planar_scanner.cpp:67-113); the beam
        # model does not need one but recalcWeight still reads distances, so
        # build it always (the reference's beam config also ends up building
        # it through the default LF else-branch at node_2d.cpp:250-255).
        omap = omap.with_distance_field(self.config.laser_likelihood_max_dist)
        # scanners hold map-dependent state: clear the registry (node_2d.cpp:213-217)
        self.frame_to_scanner.clear()
        self.scanner_params = []
        self.scanners_update = []
        self.latest_scan = None
        self.init_from_new_map(omap, use_initial_pose=not self.first_map_received)
        self._update_free_space_indices()
        self.first_map_received = True

    def _update_free_space_indices(self):
        """updateFreeSpaceIndices (node_2d.cpp:318-338)."""
        fsi = self.map.free_space_indices(self.config.laser_non_free_space_radius)
        origin = np.array([self.map.origin_x, self.map.origin_y])
        half = np.array([self.map.size_x // 2, self.map.size_y // 2])
        self.update_free_space_indices(fsi, origin, half, self.map.resolution)

    # ------------------------------------------------------------- scanners

    def _get_scanner_index(self, frame_id: str) -> int:
        """getFrameToScannerIndex (node_2d.cpp:428-488): lazily resolve the
        base->laser extrinsic; x/y only, mount yaw handled via angle stats."""
        if frame_id in self.frame_to_scanner:
            return self.frame_to_scanner[frame_id]
        try:
            tf = self.tf.lookup(self.config.base_frame_id, frame_id)
        except TransformLookupError:
            log.error("Couldn't transform from %s to %s", frame_id, self.config.base_frame_id)
            return -1
        idx = len(self.scanner_params)
        pose = np.array([tf.translation[0], tf.translation[1], 0.0])
        self.scanner_params.append(self._base_params.replace(
            scanner_pose=jnp.asarray(pose, jnp.float32)
        ))
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

    def scan_received(self, scan: LaserScan, now: Optional[float] = None) -> None:
        """scanReceived (node_2d.cpp:340-360)."""
        now = scan.stamp if now is None else now
        self.latest_scan_received_ts = now
        if not self._is_map_initialized():
            return
        if not self.global_localization_active:
            self.deactivate_global_localization_params()
        scanner_index = self._get_scanner_index(scan.frame_id)
        if scanner_index < 0:
            return
        success, force_publication = self.update_pf(
            scan.stamp, self.scanners_update, scanner_index
        )
        resampled = False
        if success and self.scanners_update[scanner_index]:
            resampled = self._update_scanner(scan, scanner_index)
        if success and (force_publication or resampled):
            self.resample_pose(scan.stamp)

    def _update_scanner(self, scan: LaserScan, scanner_index: int) -> bool:
        """updateScanner (node_2d.cpp:367-392)."""
        cfg = self.config
        try:
            base_to_scanner = self.tf.lookup(cfg.base_frame_id, scan.frame_id, scan.stamp)
        except TransformLookupError:
            log.warning("Unable to transform scanner angles into base frame")
            return False
        with self.timers.phase("scan_prep"):
            ranges, angles, range_max = scan_prep.prepare_scan(
                scan, base_to_scanner, cfg.laser_min_range, cfg.laser_max_range,
                cfg.laser_max_beams, cfg.laser_model_type,
            )
        pscan = PlanarScan(
            ranges=jnp.asarray(ranges, jnp.float32),
            angles=jnp.asarray(angles, jnp.float32),
            range_max=jnp.float32(range_max),
        )
        self.latest_scan = pscan
        with self.timers.phase("sensor_update"):
            self.state = _sensor_update_jit(
                self.state,
                self.map,
                self.scanner_params[scanner_index],
                pscan,
                cfg.laser_model_type.value,
                cfg.do_beamskip,
                log_space=self._log_space,
            )
        self.scanners_update[scanner_index] = False
        self.resample_count += 1
        resampled = False
        if self.resample_count % cfg.resample_interval == 0:
            self.resample_particles()
            resampled = True
        if not self.force_update:
            self.publish_particle_cloud(scan.stamp)
        return resampled

    # ------------------------------------------------------------- scoring

    def score_poses(self, poses: jnp.ndarray) -> jnp.ndarray:
        """scorePose batched (node_2d.cpp:298-316): a fake 1-weight sample
        set through the full sensor model incl. map factors."""
        if self.latest_scan is None:
            return jnp.ones((poses.shape[0],), jnp.float32)
        return _score_poses_jit(
            self.map, self._base_params, self.latest_scan, poses,
            self.config.laser_model_type.value,
        )

    # ------------------------------------------------------------- watchdog

    def check_scan_received(self, now: float) -> Optional[str]:
        """checkScanReceived (node_2d.cpp:619-627): returns a warning string
        when no scan has arrived for 15 s (the app decides how to surface it)."""
        if self.latest_scan_received_ts is None:
            return None
        d = now - self.latest_scan_received_ts
        if d > SCAN_WATCHDOG_INTERVAL:
            msg = (
                f"No planar scan received (and thus no pose updates have been "
                f"published) for {d:.1f} seconds."
            )
            log.warning(msg)
            return msg
        return None
