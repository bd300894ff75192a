"""Typed configuration for the framework.

Re-expresses the reference's two-tier config system — rosparam reads at
construction (reference src/amcl/node/node.cpp:61-131, node_2d.cpp:49-98,
node_3d.cpp:58-94) plus the dynamic_reconfigure spec (cfg/AMCL.cfg:14-123) —
as one typed, hot-reloadable dataclass. Field names and defaults mirror the
reference parameter names so launch configs translate 1:1.

Live retune: `Node.reconfigure(new_config)` mirrors the reference's
`reconfigureCB` (node.cpp:188-293), which rebuilds the particle filter around
the last published pose.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional


class OdomModelType(enum.Enum):
    """Odometry motion model variants (reference include/amcl/sensors/odom.h:33-40)."""

    DIFF = "diff"
    OMNI = "omni"
    DIFF_CORRECTED = "diff-corrected"
    OMNI_CORRECTED = "omni-corrected"
    GAUSSIAN = "gaussian"


class PlanarModelType(enum.Enum):
    """Planar laser measurement models (reference planar_scanner.h:36-42)."""

    BEAM = "beam"
    LIKELIHOOD_FIELD = "likelihood_field"
    LIKELIHOOD_FIELD_PROB = "likelihood_field_prob"
    LIKELIHOOD_FIELD_GOMPERTZ = "likelihood_field_gompertz"


class PointCloudModelType(enum.Enum):
    """3D point-cloud measurement models (reference point_cloud_scanner.h:39-43)."""

    POINT_CLOUD = "likelihood_field"
    POINT_CLOUD_GOMPERTZ = "likelihood_field_gompertz"


class ResampleModelType(enum.Enum):
    """Resampling schemes (reference particle_filter.h / node.cpp:109-118)."""

    MULTINOMIAL = "multinomial"
    SYSTEMATIC = "systematic"


# Reference rosparam spellings that differ from our field names. The 2D node
# reads `laser_scanner_*` (node_2d.cpp:66-68) and
# `global_localization_planar_*` (node_2d.cpp:74-77) while the 3D node reads
# `laser_*` (node_3d.cpp:64-66) and `global_localization_scanner_*`
# (node_3d.cpp:75-77); both map onto one knob set here. The trailing
# underscore in `beam_skip_error_threshold_` is a reference quirk
# (node_2d.cpp:73) preserved as an accepted alias.
REFERENCE_PARAM_ALIASES = {
    "laser_scanner_off_map_factor": "laser_off_map_factor",
    "laser_scanner_non_free_space_factor": "laser_non_free_space_factor",
    "laser_scanner_non_free_space_radius": "laser_non_free_space_radius",
    "global_localization_planar_off_map_factor": "global_localization_laser_off_map_factor",
    "global_localization_planar_non_free_space_factor": "global_localization_laser_non_free_space_factor",
    "global_localization_scanner_off_map_factor": "global_localization_laser_off_map_factor",
    "global_localization_scanner_non_free_space_factor": "global_localization_laser_non_free_space_factor",
    "beam_skip_error_threshold_": "beam_skip_error_threshold",
}

# Params the reference declares but never reads (verified against all
# private_nh_.param sites): silently accepted so reference launch configs
# load unmodified.
# - odom_integrator_topic: set by both shipped launches, but node.cpp:155-156
#   hardcodes the "odom" topic and never reads the param.
# - global_localization_point_cloud_scanner_*: the 3D launch's spellings
#   (badger_amcl_3d.launch:62-63); the code reads
#   `global_localization_scanner_*` instead (node_3d.cpp:75-77), so these
#   exact spellings are declared-but-unread — accepted and IGNORED, like the
#   reference does.
REFERENCE_UNREAD_PARAMS = frozenset(
    {
        "gui_publish_rate",
        "use_map_topic",
        "off_object_penalty_factor",
        "odom_integrator_topic",
        "global_localization_point_cloud_scanner_off_map_factor",
        "global_localization_point_cloud_scanner_non_free_space_factor",
    }
)

# Keys this framework once read and no longer does: the kernel-backend
# switch and the beam-model range-image bins. The exact float32 XLA path is
# now the only backend. Old config files that still set them load; the key
# is ignored with a warning.
RETIRED_PARAMS = frozenset({"compute_backend", "beam_range_image_bins"})


def _parse_enum(enum_cls, value, default):
    """Reference behavior: unknown enum strings warn and fall back to the default
    (node.cpp:97-101,114-118; node_2d.cpp:89-92)."""
    if isinstance(value, enum_cls):
        return value
    try:
        return enum_cls(value)
    except ValueError:
        return default


@dataclasses.dataclass
class AMCLConfig:
    """All runtime-tunable knobs. Defaults match the reference's defaults
    (node.cpp:61-131, node_2d.cpp:49-98, node_3d.cpp:58-94, cfg/AMCL.cfg)."""

    # --- map selection (node.cpp:61) ---
    map_type: int = 2  # 2 = occupancy grid, 3 = octomap

    # --- filter size & KLD (node.cpp:69-72) ---
    min_particles: int = 100
    max_particles: int = 5000
    kld_err: float = 0.01
    kld_z: float = 0.99

    # --- update & resample gating (node.cpp:103-104; node_2d.cpp:69) ---
    update_min_d: float = 0.2
    update_min_a: float = math.pi / 6.0
    resample_interval: int = 2

    # --- odometry motion model (node.cpp:73-78,86-101) ---
    odom_integrator_enabled: bool = True
    odom_model_type: OdomModelType = OdomModelType.DIFF
    odom_alpha1: float = 0.2
    odom_alpha2: float = 0.2
    odom_alpha3: float = 0.2
    odom_alpha4: float = 0.2
    odom_alpha5: float = 0.2

    # --- resampling & recovery (node.cpp:109-127) ---
    resample_model_type: ResampleModelType = ResampleModelType.MULTINOMIAL
    recovery_alpha_slow: float = 0.001
    recovery_alpha_fast: float = 0.1
    uniform_pose_starting_weight_threshold: float = 0.0
    uniform_pose_deweight_multiplier: float = 0.0
    global_localization_alpha_slow: float = 0.001
    global_localization_alpha_fast: float = 0.1
    global_localization_convergence_threshold: float = 95.0  # percent (node.cpp:79)

    # --- frames & TF (node.cpp:105-108,120-131) ---
    odom_frame_id: str = "odom"
    base_frame_id: str = "base_link"
    global_frame_id: str = "map"
    global_alt_frame_id: str = ""
    transform_tolerance: float = 0.1
    tf_broadcast: bool = True
    tf_reverse: bool = False
    transform_publish_rate: float = 50.0

    # --- pose persistence (node.cpp:66-67,81-83) ---
    save_pose: bool = False
    saved_pose_filepath: str = "badger_amcl_saved_pose.yaml"
    save_pose_to_file_rate: float = 0.1

    # --- planar laser sensor model (node_2d.cpp:49-98) ---
    laser_model_type: PlanarModelType = PlanarModelType.LIKELIHOOD_FIELD
    laser_min_range: float = -1.0
    laser_max_range: float = -1.0
    laser_max_beams: int = 30
    laser_z_hit: float = 0.95
    laser_z_short: float = 0.1
    laser_z_max: float = 0.05
    laser_z_rand: float = 0.05
    laser_sigma_hit: float = 0.2
    laser_lambda_short: float = 0.1
    laser_likelihood_max_dist: float = 2.0
    laser_gompertz_a: float = 1.0
    laser_gompertz_b: float = 1.0
    laser_gompertz_c: float = 1.0
    laser_gompertz_input_shift: float = 0.0
    laser_gompertz_input_scale: float = 1.0
    laser_gompertz_output_shift: float = 0.0
    laser_off_map_factor: float = 1.0
    laser_non_free_space_factor: float = 1.0
    laser_non_free_space_radius: float = 0.0
    do_beamskip: bool = False
    beam_skip_distance: float = 0.5
    beam_skip_threshold: float = 0.3
    beam_skip_error_threshold: float = 0.9
    global_localization_laser_off_map_factor: float = 1.0
    global_localization_laser_non_free_space_factor: float = 1.0

    # log-space-resident weight pipeline for likelihood_field_prob (new; no
    # reference equivalent): keeps per-particle LOG weights through
    # normalization and the w_slow/w_fast averages in log domain, so the
    # prob model's beam product no longer underflows f32 past ~60 beams
    # (pf/filter.py sensor_update_log). Off by default — the default exp
    # path is reference-exact.
    laser_likelihood_log_space: bool = False

    # --- map handling (node_2d.cpp:49,93-98; node_3d.cpp:58-59,94) ---
    first_map_only: bool = False
    map_scale_up_factor: int = 1
    wait_for_occupancy_map: bool = False

    # --- 3D point-cloud model (node_3d.cpp:58-94). The reference reuses the
    # laser_* param names for the 3D scanner; we do the same. 3D-specific
    # defaults that differ from 2D are provided via `for_3d()`.
    cloud_max_beams: Optional[int] = None  # None -> laser_max_beams (3D default 256)
    cloud_likelihood_max_dist: Optional[float] = None  # None -> 0.36 (node_3d.cpp:67)

    def __post_init__(self):
        self.odom_model_type = _parse_enum(
            OdomModelType, self.odom_model_type, OdomModelType.DIFF
        )
        self.laser_model_type = _parse_enum(
            PlanarModelType, self.laser_model_type, PlanarModelType.LIKELIHOOD_FIELD
        )
        self.resample_model_type = _parse_enum(
            ResampleModelType, self.resample_model_type, ResampleModelType.MULTINOMIAL
        )
        # min <= max coercion (reference node.cpp:244-249)
        if self.min_particles > self.max_particles:
            self.max_particles = self.min_particles
        # map_scale_up_factor clamping (node_2d.cpp:94-98)
        self.map_scale_up_factor = max(1, min(16, int(self.map_scale_up_factor)))

    # 3D pipeline resolved values -------------------------------------------------
    @property
    def resolved_cloud_max_beams(self) -> int:
        if self.cloud_max_beams is not None:
            return self.cloud_max_beams
        return self.laser_max_beams

    @property
    def resolved_cloud_likelihood_max_dist(self) -> float:
        if self.cloud_likelihood_max_dist is not None:
            return self.cloud_likelihood_max_dist
        return self.laser_likelihood_max_dist

    @classmethod
    def for_2d(cls, **overrides) -> "AMCLConfig":
        """Defaults as the reference's 2D node reads them (node_2d.cpp:49-98)."""
        base = dict(map_type=2)
        base.update(overrides)
        return cls(**base)

    @classmethod
    def for_3d(cls, **overrides) -> "AMCLConfig":
        """Defaults as the reference's 3D node reads them (node_3d.cpp:58-94):
        max_beams 256, likelihood_max_dist 0.36, gompertz model default."""
        base = dict(
            map_type=3,
            laser_max_beams=256,
            laser_likelihood_max_dist=0.36,
            laser_model_type=PlanarModelType.LIKELIHOOD_FIELD_GOMPERTZ,
        )
        base.update(overrides)
        return cls(**base)

    @property
    def point_cloud_model_type(self) -> PointCloudModelType:
        """3D model selection mirrors node_3d.cpp:78-93: "likelihood_field" ->
        plain model, anything gompertz -> gompertz, unknown -> plain."""
        if self.laser_model_type == PlanarModelType.LIKELIHOOD_FIELD_GOMPERTZ:
            return PointCloudModelType.POINT_CLOUD_GOMPERTZ
        return PointCloudModelType.POINT_CLOUD

    def replace(self, **changes) -> "AMCLConfig":
        return dataclasses.replace(self, **changes)

    def merge_params(self, raw: dict, warn=None) -> "AMCLConfig":
        """This config updated with a reference-style param dict — the
        dynamic_reconfigure delta contract (node.cpp:188-293): params absent
        from `raw` keep their current values. Same alias/unread-param
        handling as `from_params`; dataclasses.replace re-runs
        __post_init__, so enum parsing and min<=max coercion apply."""
        return dataclasses.replace(self, **_known_params(raw, warn))

    @classmethod
    def from_params(cls, raw: dict, warn=None) -> "AMCLConfig":
        """Build a config from a reference-style rosparam dict.

        Accepts the reference's exact parameter spellings (aliases above),
        silently drops params the reference declares but never reads, and
        warns (via `warn`, default logging) on retired keys and anything
        unknown — the reference's own behavior for unparsed params is to
        ignore them."""
        return cls(**_known_params(raw, warn))


def _known_params(raw: dict, warn=None) -> dict:
    """The AMCLConfig fields of a reference-style param dict, with aliases
    resolved. Declared-but-unread params drop silently; retired and unknown
    keys drop with a warning."""
    if warn is None:
        import logging

        warn = logging.getLogger("badger_amcl").warning
    fields = {f.name for f in dataclasses.fields(AMCLConfig)}
    known, retired, unknown = {}, [], []
    for k, v in raw.items():
        k = REFERENCE_PARAM_ALIASES.get(k, k)
        if k in fields:
            known[k] = v
        elif k in RETIRED_PARAMS:
            retired.append(k)
        elif k not in REFERENCE_UNREAD_PARAMS:
            unknown.append(k)
    if retired:
        warn("Ignoring retired config keys (the exact XLA path is the only "
             "backend): %s", sorted(retired))
    if unknown:
        warn("Ignoring unknown config keys: %s", sorted(unknown))
    return known
