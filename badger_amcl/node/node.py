"""Shared localization node: lifecycle, update gating, odometry integration,
pose publication, persistence, global localization.

Host-shim re-design of the reference's `Node` (src/amcl/node/node.cpp,
1242 LoC). ROS plumbing becomes:

- pub/sub topics  -> an output-callback registry (`subscribe_output`)
- tf2 buffer      -> node.transforms.TransformBuffer owned by the app
- timers/spinners -> the app drives `spin_once(now)`; the single-writer host
                     loop replaces the reference's mutex structure
                     (configuration_mutex_/tf_mutex_/latest_pose_mutex_,
                     node.h:208-210)
- dynamic_reconfigure -> `reconfigure(new_config)` with the same
                     rebuild-the-filter semantics (node.cpp:188-293)

All filter math lives on device in MCLState; this layer only gates, packs,
and publishes.
"""

from __future__ import annotations

import functools
import logging
import math
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from badger_amcl.config import AMCLConfig, OdomModelType, ResampleModelType
from badger_amcl.node import persistence
from badger_amcl.node.messages import (
    COVARIANCE_AA,
    COVARIANCE_XX,
    COVARIANCE_YY,
    Odometry,
    Pose2D,
    PoseArray,
    PoseWithCovarianceStamped,
    TransformStamped,
)
from badger_amcl.node.transforms import (
    Transform,
    TransformBuffer,
    TransformLookupError,
)
from badger_amcl.pf import filter as pf_filter
from badger_amcl.pf.filter import ResampleModel
from badger_amcl.pf.types import PFParams
from badger_amcl.sensors import odom as odom_models
from badger_amcl.utils.angles import shortest_angular_distance
from badger_amcl.utils.profiling import PhaseTimer

log = logging.getLogger("badger_amcl")

_ODOM_MODEL_MAP = {
    OdomModelType.DIFF: odom_models.OdomModel.DIFF,
    OdomModelType.OMNI: odom_models.OdomModel.OMNI,
    OdomModelType.DIFF_CORRECTED: odom_models.OdomModel.DIFF_CORRECTED,
    OdomModelType.OMNI_CORRECTED: odom_models.OdomModel.OMNI_CORRECTED,
    OdomModelType.GAUSSIAN: odom_models.OdomModel.GAUSSIAN,
}

_RESAMPLE_MODEL_MAP = {
    ResampleModelType.MULTINOMIAL: ResampleModel.MULTINOMIAL,
    ResampleModelType.SYSTEMATIC: ResampleModel.SYSTEMATIC,
}

# default initial covariance (node.cpp:147-150)
DEFAULT_COV = (0.5 * 0.5, 0.5 * 0.5, (math.pi / 12.0) ** 2)


@functools.partial(jax.jit, static_argnames=("model",))
def _motion_update_jit(state, model, alphas, pose, delta, absolute_motion):
    return odom_models.motion_update(state, model, alphas, pose, delta, absolute_motion)


@functools.partial(jax.jit, static_argnames=("resample_model", "log_averages"))
def _resample_jit(state, params, pool, resample_model, log_averages=False):
    return pf_filter.resample(state, params, pool, resample_model,
                              log_averages=log_averages)


@jax.jit
def _uniform_pool_jit(key, fsi, map_to_world_origin, half, resolution, m):
    """Batched randomFreeSpacePose (node.cpp:822-839): uniform free cell +
    uniform yaw in (-pi, pi]. fsi: (F, 2) int32 device array."""
    k1, k2 = jax.random.split(key)
    idx = (jax.random.uniform(k1, (m.shape[0],)) * fsi.shape[0]).astype(jnp.int32)
    ij = fsi[idx]
    xy = map_to_world_origin + (ij - half).astype(jnp.float32) * resolution
    yaw = jax.random.uniform(k2, (m.shape[0],)) * 2.0 * jnp.pi - jnp.pi
    return jnp.concatenate([xy, yaw[:, None]], axis=1)


class Node:
    """Shared node logic; Node2D / Node3D add the sensor pipelines."""

    def __init__(
        self,
        config: AMCLConfig,
        tf_buffer: Optional[TransformBuffer] = None,
        seed: int = 0,
    ):
        self.config = config
        # restore_defaults snapshot (reference default_config_, node.cpp:192-197)
        self.default_config = config
        self.tf = tf_buffer if tf_buffer is not None else TransformBuffer()
        self._outputs: Dict[str, List[Callable]] = {}
        self.key = jax.random.PRNGKey(seed)
        self.timers = PhaseTimer()  # per-phase host timing (SURVEY.md §5)

        self.params = PFParams(
            min_samples=config.min_particles,
            max_samples=config.max_particles,
            pop_err=config.kld_err,
            pop_z=config.kld_z,
            convergence_threshold=config.global_localization_convergence_threshold,
        )
        self.state = None  # MCLState, created on first map (node.cpp:670-709)
        self.map = None

        # odometry bookkeeping (node.cpp:716-793,1019-1112)
        self.odom_init = False
        self.pf_odom_pose = np.zeros(3)
        self.odom_integrator_ready = False
        self.odom_integrator_last_pose = np.zeros(3)
        self.odom_integrator_absolute_motion = np.zeros(3)
        self.latest_odom_pose: Optional[Transform] = None

        # pose outputs (node.cpp:359-444,885-963)
        self.latest_tf: Optional[Transform] = None
        self.latest_tf_valid = False
        self.sent_first_transform = False
        self.last_published_pose: Optional[PoseWithCovarianceStamped] = None
        self.latest_pose: Optional[PoseWithCovarianceStamped] = None

        self.global_localization_active = False
        self.free_space_indices: Optional[jnp.ndarray] = None
        self._fsi_geom = None  # (origin (2,), half (2,), resolution)

        self.resample_count = 0
        self.force_update = False

        # init pose from file or defaults (loadPose, node.cpp:460-478)
        self.default_cov = np.array(DEFAULT_COV)
        loaded = persistence.load_pose_from_file(
            config.saved_pose_filepath, DEFAULT_COV
        )
        if loaded is not None:
            self.init_pose, self.init_cov = loaded
            log.info("Loaded saved pose (%.3f, %.3f)", *self.init_pose[:2])
        else:
            self.init_pose = np.zeros(3)
            self.init_cov = self.default_cov.copy()

        self._last_save_time: Optional[float] = None
        self._last_tf_publish_time: Optional[float] = None

    # ------------------------------------------------------------------ I/O

    def subscribe_output(self, topic: str, callback: Callable) -> None:
        """Register a consumer for an output topic: amcl_pose, particlecloud,
        tf, amcl_map_odom_transform, amcl_absolute_motion (+ alt-frame
        variants when global_alt_frame_id is set).

        amcl_pose is latched: a new subscriber immediately receives the
        latest localized pose if one exists (newInitialPoseSubscriber,
        node.cpp:1004-1017)."""
        self._outputs.setdefault(topic, []).append(callback)
        if topic == "amcl_pose" and self.latest_pose is not None:
            if self.latest_pose.frame_id == "map":
                callback(self.latest_pose)

    def _publish(self, topic: str, msg) -> None:
        for cb in self._outputs.get(topic, []):
            cb(msg)

    # -------------------------------------------------------- pf lifecycle

    def _next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def init_from_new_map(self, new_map, use_initial_pose: bool) -> None:
        """initFromNewMap (node.cpp:670-709): build the filter around the
        saved/default initial pose."""
        self.map = new_map
        if not use_initial_pose:
            return
        mean = jnp.asarray(self.init_pose, jnp.float32)
        cov = jnp.diag(jnp.asarray(self.init_cov, jnp.float32))
        self.state = pf_filter.init_with_gaussian(
            self.params,
            self._next_key(),
            mean,
            cov,
            alpha_slow=self.config.recovery_alpha_slow,
            alpha_fast=self.config.recovery_alpha_fast,
        )
        self._after_pf_init()
        self.odom_init = False

    def set_pf_decay_rate_normal(self) -> None:
        """setPfDecayRateNormal (node.cpp:295-298)."""
        if self.state is not None:
            self.state = self.state.replace(
                alpha_slow=jnp.float32(self.config.recovery_alpha_slow),
                alpha_fast=jnp.float32(self.config.recovery_alpha_fast),
            )

    def update_free_space_indices(self, fsi: np.ndarray, origin_xy, half_xy, resolution):
        """updateFreeSpaceIndices (node.cpp:711-714) + geometry needed for
        on-device pose generation."""
        self.free_space_indices = jnp.asarray(fsi, jnp.int32)
        self._fsi_geom = (
            jnp.asarray(origin_xy, jnp.float32),
            jnp.asarray(half_xy, jnp.int32),
            jnp.float32(resolution),
        )

    @property
    def _log_space(self) -> bool:
        """Log-space-resident weight pipeline active (config knob; only
        meaningful for likelihood_field_prob — see pf.filter
        sensor_update_log)."""
        from badger_amcl.config import PlanarModelType

        return bool(
            getattr(self.config, "laser_likelihood_log_space", False)
            and self.config.laser_model_type
            == PlanarModelType.LIKELIHOOD_FIELD_PROB
        )

    def _after_pf_init(self) -> None:
        """Post-init state fixups: the log-space contract stores w_slow/
        w_fast in log domain, whose 'uninitialized' sentinel differs."""
        if self._log_space and self.state is not None:
            self.state = pf_filter.init_log_averages(self.state)

    # ------------------------------------------------ random pose generation

    def random_pose_pool(self, m: Optional[int] = None) -> jnp.ndarray:
        """Batched uniformPoseGenerator (node.cpp:847-868): uniform free-space
        poses, optionally score-rejected against the latest scan with a
        per-slot decaying threshold."""
        if m is None:
            m = self.params.max_samples
        if self.free_space_indices is None:
            return jnp.zeros((m, 3), jnp.float32)
        origin, half, res = self._fsi_geom
        dummy = jnp.zeros((m,), jnp.float32)

        def draw(key):
            return _uniform_pool_jit(key, self.free_space_indices, origin, half, res, dummy)

        poses = draw(self._next_key())
        thr0 = self.config.uniform_pose_starting_weight_threshold
        mult = self.config.uniform_pose_deweight_multiplier
        if thr0 > 0.0 and 0.0 <= mult < 1.0:
            # batched rejection: each slot independently redraws with its own
            # decaying threshold until accepted (bounded rounds)
            thr = jnp.full((m,), thr0, jnp.float32)
            accepted = jnp.zeros((m,), bool)
            for _ in range(100):
                scores = self.score_poses(poses)
                accepted = accepted | (scores >= thr)
                if bool(jnp.all(accepted)):
                    break
                fresh = draw(self._next_key())
                poses = jnp.where(accepted[:, None], poses, fresh)
                thr = jnp.where(accepted, thr, thr * mult)
        return poses

    def score_poses(self, poses: jnp.ndarray) -> jnp.ndarray:
        """scorePose batched (NodeND::scorePose) — subclass supplies the
        sensor model; no scan data -> perfect score (node_2d.cpp:298-316)."""
        return jnp.ones((poses.shape[0],), jnp.float32)

    # ----------------------------------------------------- odometry / gating

    def integrate_odom(self, msg: Odometry) -> None:
        """integrateOdom (node.cpp:726-793): accumulate absolute
        |trans|/|strafe|/|rot| between filter updates."""
        if not self.config.odom_integrator_enabled:
            return
        pose = np.asarray(msg.pose, float)
        if not self.odom_integrator_ready:
            self.odom_integrator_absolute_motion = np.zeros(3)
            self.odom_integrator_ready = True
        else:
            last = self.odom_integrator_last_pose
            delta = np.array(
                [
                    pose[0] - last[0],
                    pose[1] - last[1],
                    float(shortest_angular_distance(last[2], pose[2])),
                ]
            )
            delta_trans = math.hypot(delta[0], delta[1])
            delta_rot = delta[2]
            if delta_trans < 1e-6:
                delta_bearing = 0.0
            else:
                angle_a = math.atan2(delta[1], delta[0])
                angle_b = last[2] + delta_rot / 2.0
                delta_bearing = float(shortest_angular_distance(angle_b, angle_a))
            cs, sn = math.cos(delta_bearing), math.sin(delta_bearing)
            self.odom_integrator_absolute_motion += np.abs(
                [delta_trans * cs, delta_trans * sn, delta_rot]
            )
        self.odom_integrator_last_pose = pose

    def get_odom_pose(self, t: float) -> Optional[np.ndarray]:
        """getOdomPose (node.cpp:795-820): odom->base at time t."""
        try:
            tf = self.tf.lookup(self.config.odom_frame_id, self.config.base_frame_id, t)
        except TransformLookupError as e:
            log.info("Failed to compute odom pose, skipping scan (%s)", e)
            return None
        self.latest_odom_pose = tf
        return tf.to_pose2d()

    def update_pf(self, t: float, scanners_update: List[bool], scanner_index: int):
        """updatePf (node.cpp:300-328). Mutates scanners_update; returns
        (success, force_publication)."""
        pose = self.get_odom_pose(t)
        if pose is None:
            return False, False
        force_publication = False
        if self.odom_init:
            delta = np.array(
                [
                    pose[0] - self.pf_odom_pose[0],
                    pose[1] - self.pf_odom_pose[1],
                    float(shortest_angular_distance(self.pf_odom_pose[2], pose[2])),
                ]
            )
            self._set_scanners_update_flags(delta, scanners_update)
            if scanners_update[scanner_index]:
                self._update_odom(pose, delta)
        else:
            # initOdom (node.cpp:1099-1112)
            self.pf_odom_pose = pose
            self.odom_init = True
            for i in range(len(scanners_update)):
                scanners_update[i] = True
            force_publication = True
            self.resample_count = 0
            self.odom_integrator_ready = False
        return True, force_publication

    def _set_scanners_update_flags(self, delta, scanners_update):
        """setScannersUpdateFlags (node.cpp:1027-1051)."""
        cfg = self.config
        if cfg.odom_integrator_enabled:
            m = self.odom_integrator_absolute_motion
            abs_trans = math.hypot(m[0], m[1])
            update = abs_trans >= cfg.update_min_d or m[2] >= cfg.update_min_a
        else:
            update = (
                abs(delta[0]) > cfg.update_min_d
                or abs(delta[1]) > cfg.update_min_d
                or abs(delta[2]) > cfg.update_min_a
            )
        update = update or self.force_update
        self.force_update = False
        if update:
            for i in range(len(scanners_update)):
                scanners_update[i] = True

    def _update_odom(self, pose, delta):
        """updateOdom (node.cpp:1053-1097): pick absolute motion vs delta,
        publish it, run the motion model on device."""
        cfg = self.config
        if cfg.odom_integrator_enabled:
            m = self.odom_integrator_absolute_motion
            abs_trans = math.hypot(m[0], m[1])
            if abs_trans >= 2 * cfg.update_min_d or m[2] >= 2 * cfg.update_min_a:
                absolute_motion = delta  # too much accumulation: fall back
            else:
                absolute_motion = m.copy()
            self._publish(
                "amcl_absolute_motion",
                Pose2D(absolute_motion[0], absolute_motion[1], absolute_motion[2]),
            )
        else:
            absolute_motion = delta
        alphas = jnp.asarray(
            [cfg.odom_alpha1, cfg.odom_alpha2, cfg.odom_alpha3, cfg.odom_alpha4,
             cfg.odom_alpha5],
            jnp.float32,
        )
        self.state = _motion_update_jit(
            self.state,
            _ODOM_MODEL_MAP[cfg.odom_model_type],
            alphas,
            jnp.asarray(pose, jnp.float32),
            jnp.asarray(delta, jnp.float32),
            jnp.asarray(absolute_motion, jnp.float32),
        )
        self.odom_integrator_absolute_motion = np.zeros(3)
        self.pf_odom_pose = np.asarray(pose, float)

    # ------------------------------------------------------------ resampling

    def resample_particles(self) -> None:
        """updateResample through the node (resampleParticles,
        node_2d.cpp:562-570)."""
        with self.timers.phase("resample"):
            pool = self.random_pose_pool()
            self.state = _resample_jit(
                self.state,
                self.params,
                pool,
                _RESAMPLE_MODEL_MAP[self.config.resample_model_type],
                self._log_space,
            )
        if bool(self.state.converged) and self.global_localization_active:
            log.info("Global localization converged!")
            self.global_localization_active = False

    # -------------------------------------------------------- pose outputs

    def publish_particle_cloud(self, stamp: float) -> None:
        """publishParticleCloud (node.cpp:335-357)."""
        n = int(self.state.n_active)
        poses = np.asarray(self.state.poses)[:n]
        msg = PoseArray(stamp, self.config.global_frame_id, poses)
        self._publish("particlecloud", msg)
        if self.config.global_alt_frame_id:
            alt = PoseArray(stamp, self.config.global_alt_frame_id, poses)
            self._publish("particlecloud_in_" + self.config.global_alt_frame_id, alt)

    def get_max_weight_pose(self):
        """getMaxWeightPose (node_2d.cpp:588-617): argmax-weight cluster mean."""
        w, mean = pf_filter.max_weight_cluster(self.state.stats)
        return float(w), np.asarray(mean, float)

    def resample_pose(self, stamp: float) -> bool:
        """resamplePose (node_2d.cpp:572-586)."""
        max_weight, max_pose = self.get_max_weight_pose()
        if max_weight > 0.0:
            return self.update_pose(max_pose, stamp)
        log.error("No pose!")
        return False

    def update_pose(self, max_pose: np.ndarray, stamp: float) -> bool:
        """updatePose (node.cpp:359-433): publish amcl_pose with the overall
        filter covariance, derive the map->odom transform."""
        if self.state is None:
            return False
        cov6 = np.zeros(36)
        set_cov = np.asarray(self.state.stats.cov)
        for i in range(2):
            for j in range(2):
                cov6[6 * i + j] = set_cov[i, j]
        cov6[COVARIANCE_AA] = set_cov[2, 2]
        p = PoseWithCovarianceStamped(
            stamp, self.config.global_frame_id, np.asarray(max_pose, float), cov6
        )
        self._publish("amcl_pose", p)
        if self.config.global_alt_frame_id:
            alt = PoseWithCovarianceStamped(
                stamp, self.config.global_alt_frame_id, p.pose.copy(), p.covariance.copy()
            )
            self._publish("amcl_pose_in_" + self.config.global_alt_frame_id, alt)
        self.last_published_pose = p

        base_to_map = Transform.from_pose2d(max_pose).inverse()
        try:
            t_odom_base = self.tf.lookup(
                self.config.odom_frame_id, self.config.base_frame_id, stamp
            )
        except TransformLookupError:
            log.warning("Failed to lookup base to odom transform, unable to update pose")
            return False
        # odom->map = T(odom<-base) * T(base<-map)  (node.cpp:401-431)
        self.latest_tf = t_odom_base.compose(base_to_map)
        self.latest_tf_valid = True
        return True

    def get_latest_tf(self, now: float) -> Optional[Transform]:
        """getLatestTf (node.cpp:923-943) with the initial-pose bootstrap."""
        if not self.latest_tf_valid:
            self.update_pose(self.init_pose, now)
        return self.latest_tf if self.latest_tf_valid else None

    def publish_transform(self, now: float) -> None:
        """publishTransform (node.cpp:885-921): future-dated map->odom TF
        (or reversed) + the Odometry mirror."""
        if not self.config.tf_broadcast:
            return
        tf = self.get_latest_tf(now)
        if tf is None:
            return
        expiration = now + self.config.transform_tolerance
        if self.config.tf_reverse:
            frame, child = self.config.odom_frame_id, self.config.global_frame_id
        else:
            frame, child = self.config.global_frame_id, self.config.odom_frame_id
            tf = tf.inverse()
        msg = TransformStamped(expiration, frame, child, tf.translation.copy(), tf.rotation.copy())
        odom_mirror = Odometry(now, tf.to_pose2d())
        self._publish("amcl_map_odom_transform", odom_mirror)
        self._publish("tf", msg)
        self.sent_first_transform = True

    # ------------------------------------------------------------ persistence

    def attempt_save_pose(self, now: float, exiting: bool = False) -> None:
        """attemptSavePose (node.cpp:446-458) + savePoseToFile gating."""
        if not self.config.save_pose:
            return
        tf = self.get_latest_tf(now)
        if tf is None or not self.latest_tf_valid:
            return
        if self.latest_odom_pose is None or self.last_published_pose is None:
            return
        # getLatestPose (node.cpp:945-963): map pose = latest_tf^-1 * odom pose
        map_pose = tf.inverse().compose(self.latest_odom_pose)
        pose = PoseWithCovarianceStamped(
            now, "map", map_pose.to_pose2d(), np.zeros(36)
        )
        for idx in (COVARIANCE_XX, COVARIANCE_YY, COVARIANCE_AA):
            pose.covariance[idx] = self.last_published_pose.covariance[idx]
        self.latest_pose = pose
        persistence.save_pose_to_file(self.config.saved_pose_filepath, pose, exiting)

    # -------------------------------------------------------- initial pose

    def initial_pose_received(self, msg: PoseWithCovarianceStamped, now: float) -> None:
        """initialPoseReceived (node.cpp:965-1002): frame checks, NaN
        rejection, covariance fallback, odometric forward-integration of
        stale poses."""
        cfg = self.config
        frame_id = msg.frame_id
        if frame_id == cfg.global_alt_frame_id and frame_id:
            frame_id = cfg.global_frame_id  # resolveFrameId (node.cpp:1114-1123)
        if frame_id == "":
            log.warning("Received initial pose with empty frame_id")
            return
        if frame_id != cfg.global_frame_id:
            log.warning("Ignoring initial pose in frame %r", frame_id)
            return
        if np.isnan(msg.pose).any():
            log.warning("Received initial pose with NAN; ignoring")
            return
        cov = np.where(np.isnan(msg.covariance), self._default_cov6(), msg.covariance)

        # transformMsgToTfPose (node.cpp:1172-1201): integrate odometric
        # change between the message stamp and now
        pose_old = Transform.from_pose2d(msg.pose)
        try:
            t_old = self.tf.lookup(cfg.odom_frame_id, cfg.base_frame_id, msg.stamp)
            t_now = self.tf.lookup(cfg.odom_frame_id, cfg.base_frame_id, now)
            tx_odom = t_old.inverse().compose(t_now)
        except TransformLookupError:
            if self.sent_first_transform:
                log.warning("Failed to transform initial pose in time")
            tx_odom = Transform.identity()
        pose = pose_old.compose(tx_odom)
        self._set_initial_pose(pose, cov)

    def _default_cov6(self):
        cov = np.zeros(36)
        cov[COVARIANCE_XX] = self.default_cov[0]
        cov[COVARIANCE_YY] = self.default_cov[1]
        cov[COVARIANCE_AA] = self.default_cov[2]
        return cov

    def _set_initial_pose(self, pose: Transform, cov6: np.ndarray) -> None:
        """setInitialPoseHyp + applyInitialPose (node.cpp:980-1002,1203-1230)."""
        if self.map is None:
            return
        mean = pose.to_pose2d()
        cov3 = np.zeros((3, 3))
        for i in range(2):
            for j in range(2):
                cov3[i, j] = cov6[6 * i + j]
            cov3[i, 2] = cov6[6 * i + 5]
            cov3[2, i] = cov6[6 * 5 + i]
        cov3[2, 2] = cov6[35]
        self.state = pf_filter.init_with_gaussian(
            self.params,
            self._next_key(),
            jnp.asarray(mean, jnp.float32),
            jnp.asarray(cov3, jnp.float32),
            alpha_slow=self.config.recovery_alpha_slow,
            alpha_fast=self.config.recovery_alpha_fast,
        )
        self._after_pf_init()
        self.odom_init = False
        self.global_localization_active = False
        log.info("Initial pose received: (%.3f, %.3f)", mean[0], mean[1])

    # ------------------------------------------------- global localization

    def global_localization(self) -> None:
        """globalLocalizationCallback (node.cpp:870-883): gl decay rates, gl
        map factors (subclass), re-init from the uniform pose generator."""
        if self.map is None:
            return
        self.global_localization_active = True
        self._apply_global_localization_factors()
        pool = self.random_pose_pool(self.params.max_samples)
        self.state = pf_filter.init_with_poses(
            self.params,
            self._next_key(),
            pool,
            alpha_slow=self.config.global_localization_alpha_slow,
            alpha_fast=self.config.global_localization_alpha_fast,
        )
        self._after_pf_init()
        self.odom_init = False

    def _apply_global_localization_factors(self) -> None:
        """Subclass: push gl off-map/non-free factors into scanner params."""

    def deactivate_global_localization_params(self) -> None:
        """deactivateGlobalLocalizationParams (node_2d.cpp:414-426)."""
        self.set_pf_decay_rate_normal()
        self._apply_normal_factors()

    def _apply_normal_factors(self) -> None:
        """Subclass: restore normal map factors."""

    # ------------------------------------------------------------- reconfigure

    def reconfigure(
        self, new_config: Optional[AMCLConfig] = None, restore_defaults: bool = False
    ) -> None:
        """reconfigureCB (node.cpp:188-293): adopt the new config and rebuild
        the filter around the last published pose.

        `restore_defaults=True` discards `new_config` and reverts to the
        config snapshotted at construction — the reference's
        `config.restore_defaults` path (node.cpp:201-206), whose
        `default_config_` is captured on the no-op first callback at startup
        (node.cpp:192-197); our construction-time snapshot is the same
        moment."""
        if restore_defaults:
            new_config = self.default_config
        if new_config is None:
            raise ValueError("reconfigure needs new_config or restore_defaults=True")
        self.config = new_config
        self.params = PFParams(
            min_samples=new_config.min_particles,
            max_samples=new_config.max_particles,
            pop_err=new_config.kld_err,
            pop_z=new_config.kld_z,
            convergence_threshold=new_config.global_localization_convergence_threshold,
        )
        if self.last_published_pose is not None:
            mean = self.last_published_pose.pose
            cov = self.last_published_pose.covariance
            cov3 = np.diag([cov[COVARIANCE_XX], cov[COVARIANCE_YY], cov[COVARIANCE_AA]])
        else:
            mean = self.init_pose
            cov3 = np.diag(self.init_cov)
        self.state = pf_filter.init_with_gaussian(
            self.params,
            self._next_key(),
            jnp.asarray(mean, jnp.float32),
            jnp.asarray(cov3, jnp.float32),
            alpha_slow=new_config.recovery_alpha_slow,
            alpha_fast=new_config.recovery_alpha_fast,
        )
        self._after_pf_init()
        self.odom_init = False
        self._reconfigure_sensors()

    def _reconfigure_sensors(self) -> None:
        """Subclass: rebuild scanner params from the new config."""

    # ------------------------------------------------------------- spin

    def spin_once(self, now: float) -> None:
        """Drive the timer-equivalents: 50 Hz TF publication (node.cpp:173-178)
        and periodic pose saving (node.cpp:183-185)."""
        cfg = self.config
        tf_period = 1.0 / max(cfg.transform_publish_rate, 1e-6)
        if self._last_tf_publish_time is None or now - self._last_tf_publish_time >= tf_period:
            self.publish_transform(now)
            self._last_tf_publish_time = now
        if cfg.save_pose and cfg.save_pose_to_file_rate > 0:
            save_period = 1.0 / cfg.save_pose_to_file_rate
            if self._last_save_time is None or now - self._last_save_time >= save_period:
                self.attempt_save_pose(now)
                self._last_save_time = now

    def shutdown(self, now: float) -> None:
        """main.cpp:51: save the pose once more with on_exit=True."""
        self.attempt_save_pose(now, exiting=True)

    # ------------------------------------------------- full-state checkpoint

    def save_full_state(self, path: str) -> bool:
        """Snapshot the complete particle set (beyond the reference's
        pose-only persistence; see node/checkpoint.py)."""
        if self.state is None:
            return False
        from badger_amcl.node import checkpoint

        checkpoint.save_state(path, self.state)
        return True

    def restore_full_state(self, path: str) -> bool:
        """Resume from a full snapshot; requires a map to already be loaded
        (the sensors need it). Returns False and keeps the current state on
        any mismatch."""
        from badger_amcl.node import checkpoint

        state = checkpoint.load_state(path, self.params)
        if state is None:
            return False
        self.state = state
        self.odom_init = False
        return True
