"""3D point-cloud measurement models.

Both models of the reference's `PointCloudScanner`
(src/amcl/sensors/point_cloud_scanner.cpp): POINT_CLOUD_MODEL
(:132-167) and POINT_CLOUD_MODEL_GOMPERTZ (:169-203), plus the off-map
weight correction (recalcWeight, :205-229).

The reference's dominant cost is `getMapCloud` (:231-248): per particle it
builds a tf2 transform, round-trips the cloud PCL->msg->PCL and transforms
every point on the CPU. Here the scanner extrinsic is folded into the cloud
once per scan (host prep), and the per-particle part reduces to a batched
planar rotation — `(N,)` angles against `(B, 3)` points — followed by one
gather from the uint8 voxel EDT texture.

Cloud decimation to max_beams points is host-side scan prep
(node_3d.cpp:467-480), mirroring the 2D design.
"""

from __future__ import annotations

import jax.numpy as jnp

from badger_amcl.maps.octomap_3d import OctoMap3D
from badger_amcl.utils.pytree import pytree_dataclass


@pytree_dataclass
class PointCloudParams:
    """setPointCloudModel / setPointCloudModelGompertz / setMapFactors
    (point_cloud_scanner.cpp:53-83)."""

    z_hit: jnp.ndarray = 0.95
    z_rand: jnp.ndarray = 0.05
    sigma_hit: jnp.ndarray = 0.2
    gompertz_a: jnp.ndarray = 1.0
    gompertz_b: jnp.ndarray = 1.0
    gompertz_c: jnp.ndarray = 1.0
    input_shift: jnp.ndarray = 0.0
    input_scale: jnp.ndarray = 1.0
    output_shift: jnp.ndarray = 0.0
    off_map_factor: jnp.ndarray = 1.0
    non_free_space_factor: jnp.ndarray = 1.0
    non_free_space_radius: jnp.ndarray = 0.0


def transform_cloud_to_map(points_base: jnp.ndarray, poses: jnp.ndarray):
    """getMapCloud's math (point_cloud_scanner.cpp:231-248), batched.

    points_base: (B, 3) cloud already composed with the scanner->footprint
    extrinsic (host prep). poses: (N, 3) particle (x, y, yaw). The particle
    transform is a pure z-rotation + xy translation (z of the footprint is 0).
    Returns (N, B, 3)."""
    c = jnp.cos(poses[:, 2])[:, None]
    s = jnp.sin(poses[:, 2])[:, None]
    px, py, pz = points_base[:, 0][None], points_base[:, 1][None], points_base[:, 2][None]
    mx = poses[:, 0][:, None] + c * px - s * py
    my = poses[:, 1][:, None] + s * px + c * py
    mz = jnp.broadcast_to(pz, mx.shape)
    return jnp.stack([mx, my, mz], axis=-1)


def apply_gompertz(params: PointCloudParams, p):
    """applyGompertz (point_cloud_scanner.cpp:250-260)."""
    p = p * params.input_scale + params.input_shift
    p = params.gompertz_a * jnp.exp(-params.gompertz_b * jnp.exp(-params.gompertz_c * p))
    return p + params.output_shift


def _model_combine(omap, params, model, n_points):
    """Per-particle p from the dense (B, N) distance matrix for each model."""
    denom = 2.0 * params.sigma_hit * params.sigma_hit

    if model == "likelihood_field":
        def combine(zt):
            pz = params.z_hit * jnp.exp(-(zt * zt) / denom) \
                + params.z_rand / omap.max_distance_to_object
            return 1.0 + jnp.sum(pz * pz * pz, axis=0)
    elif model == "likelihood_field_gompertz":
        def combine(zt):
            pz = params.z_hit * jnp.exp(-(zt * zt) / denom) + params.z_rand
            return apply_gompertz(params, jnp.sum(pz, axis=0) / n_points)
    else:
        raise ValueError(f"unknown point cloud model {model!r}")
    return combine


def point_cloud_likelihood(
    omap: OctoMap3D,
    params: PointCloudParams,
    points_base: jnp.ndarray,
    poses: jnp.ndarray,
    model: str = "likelihood_field",
):
    """applyModelToSampleSet (point_cloud_scanner.cpp:106-129): returns
    (p_model (N,), map_factor (N,)).

    model == "likelihood_field": pz = z_hit exp(-z^2/2s^2) + z_rand/max_dist,
        p = 1 + sum pz^3 over all points (:132-167 — every point counts,
        there is no max-range skip for clouds).
    model == "likelihood_field_gompertz": mean pz (z_rand added raw) through
        the Gompertz squash (:169-203).
    Any other model raises."""
    combine = _model_combine(omap, params, model, points_base.shape[0])
    map_cloud = transform_cloud_to_map(points_base, poses)  # (N, B, 3)
    zt = omap.distance_at(omap.world_to_map(map_cloud)).T  # (B, N)
    return combine(zt), map_factors(omap, params, poses)


def map_factors(omap: OctoMap3D, params: PointCloudParams, poses):
    """recalcWeight (point_cloud_scanner.cpp:205-229): only the off-map
    penalty applies in 3D, judged on the particle's 2D cell validity."""
    cells = omap.world_to_map(poses[:, :2].astype(jnp.float32))
    valid = omap.is_pose_valid(cells[..., 0], cells[..., 1])
    return jnp.where(valid, 1.0, params.off_map_factor)
