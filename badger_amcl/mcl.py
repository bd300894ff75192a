"""Fused single-robot MCL step — the framework's "forward pass".

One jitted function covering the reference's full per-scan hot path
(SURVEY.md §3.1): motion update -> measurement update -> KLD resample ->
cluster statistics -> convergence. This is the unit the benchmarks measure
and the fleet layer vmaps/shards.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from badger_amcl.maps.occupancy_2d import OccupancyMap2D
from badger_amcl.pf import filter as pf_filter
from badger_amcl.pf.filter import ResampleModel
from badger_amcl.pf.types import MCLState, PFParams
from badger_amcl.sensors import odom as odom_models
from badger_amcl.sensors.planar import (
    PlanarScan,
    PlanarScanParams,
    planar_likelihood,
)


def mcl_step_2d(
    state: MCLState,
    omap: OccupancyMap2D,
    scan_params: PlanarScanParams,
    scan: PlanarScan,
    random_pose_pool: jnp.ndarray,
    odom_pose: jnp.ndarray,
    odom_delta: jnp.ndarray,
    absolute_motion: jnp.ndarray,
    alphas: jnp.ndarray,
    params: PFParams,
    odom_model: odom_models.OdomModel = odom_models.OdomModel.DIFF,
    laser_model: str = "likelihood_field",
    resample_model: ResampleModel = ResampleModel.MULTINOMIAL,
    do_resample: bool = True,
    do_beamskip: bool = False,
) -> MCLState:
    """One full 2D MCL step. Static args: params, odom_model, laser_model,
    resample_model, do_resample, do_beamskip."""
    state = odom_models.motion_update(
        state, odom_model, tuple(alphas) if isinstance(alphas, (list, tuple)) else alphas,
        odom_pose, odom_delta, absolute_motion,
    )
    p, mf = planar_likelihood(
        omap, scan_params, scan, state.poses, state.active_mask, state.n_active,
        laser_model, converged=state.converged, do_beamskip=do_beamskip,
    )
    state = pf_filter.sensor_update(state, p, mf)
    if do_resample:
        state = pf_filter.resample(state, params, random_pose_pool, resample_model)
    return state


mcl_step_2d_jit = jax.jit(
    mcl_step_2d,
    static_argnames=(
        "params", "odom_model", "laser_model", "resample_model",
        "do_resample", "do_beamskip",
    ),
)


def sensor_resample_step(
    state: MCLState,
    omap: OccupancyMap2D,
    scan_params: PlanarScanParams,
    scan: PlanarScan,
    random_pose_pool: jnp.ndarray,
    params: PFParams,
    laser_model: str = "likelihood_field",
    resample_model: ResampleModel = ResampleModel.MULTINOMIAL,
) -> MCLState:
    """The BASELINE.md benchmark unit: sensor update + KLD resample (no
    motion model), matching 'full sensor-update + KLD-resample step'."""
    p, mf = planar_likelihood(
        omap, scan_params, scan, state.poses, state.active_mask, state.n_active,
        laser_model, converged=state.converged,
    )
    state = pf_filter.sensor_update(state, p, mf)
    return pf_filter.resample(state, params, random_pose_pool, resample_model)


sensor_resample_step_jit = jax.jit(
    sensor_resample_step,
    static_argnames=("params", "laser_model", "resample_model"),
)


def likelihood_only(
    state: MCLState,
    omap: OccupancyMap2D,
    scan_params: PlanarScanParams,
    scan: PlanarScan,
    laser_model: str = "likelihood_field",
):
    """Just the particle x beam likelihood evaluation (with the map
    factors applied) — the evals/sec metric."""
    p, mf = planar_likelihood(
        omap, scan_params, scan, state.poses, state.active_mask, state.n_active,
        laser_model, converged=state.converged,
    )
    return p * mf


likelihood_only_jit = jax.jit(likelihood_only, static_argnames=("laser_model",))
