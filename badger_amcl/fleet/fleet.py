"""Fleet-scale batching: many robots, one program, a device mesh.

New capability beyond the reference (whose multi-robot story is "run one ROS
node per robot", SURVEY.md §2): the full MCL step is vmapped over a robot
axis and sharded over a `jax.sharding.Mesh` with `shard_map`. Each robot
carries its own PRNG key, map is replicated (fleets share a facility map),
scans/poses/pools are sharded along the fleet axis. No collectives are
needed in the hot path — robots are independent — so scaling is embarrassingly
parallel across devices; cross-robot aggregation (fleet health stats) is one
psum.

Targets BASELINE.json config 5: 256 robots x 10k particles.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from badger_amcl import mcl
from badger_amcl.pf import filter as pf_filter
from badger_amcl.pf.filter import ResampleModel
from badger_amcl.pf.types import PFParams
from badger_amcl.sensors import odom as odom_models


def fleet_init(params: PFParams, key: jax.Array, means, covs,
               alpha_slow=0.001, alpha_fast=0.1):
    """Stacked MCLState for R robots: means (R, 3), covs (R, 3, 3)."""
    r = means.shape[0]
    keys = jax.random.split(key, r)
    return jax.vmap(
        lambda k, m, c: pf_filter.init_with_gaussian(params, k, m, c, alpha_slow, alpha_fast)
    )(keys, jnp.asarray(means, jnp.float32), jnp.asarray(covs, jnp.float32))


def fleet_step(
    states,
    omap,
    scan_params,
    scans,
    pools,
    odom_poses,
    odom_deltas,
    absolute_motions,
    alphas,
    params: PFParams,
    odom_model: odom_models.OdomModel = odom_models.OdomModel.DIFF,
    laser_model: str = "likelihood_field",
    resample_model: ResampleModel = ResampleModel.MULTINOMIAL,
):
    """One full MCL step for every robot: `mcl.mcl_step_2d` vmapped over the
    leading robot axis R of states, scans, pools and odometry; map and
    model parameters broadcast.

    Fleet configs should set PFParams.stats_max_clusters (e.g. 128): under
    vmap the cluster-stats lax.cond lowers to select and BOTH branches
    execute, so the exact segment_sum fallback would run for every robot
    while never being taken."""
    step = functools.partial(
        mcl.mcl_step_2d,
        params=params,
        odom_model=odom_model,
        laser_model=laser_model,
        resample_model=resample_model,
        do_resample=True,
    )
    return jax.vmap(
        step, in_axes=(0, None, None, 0, 0, 0, 0, 0, None)
    )(states, omap, scan_params, scans, pools, odom_poses, odom_deltas,
      absolute_motions, alphas)


def fleet_reinit_masked(states, mask, pose_pools, params: PFParams,
                        alpha_slow=0.001, alpha_fast=0.1):
    """Global localization for a SUBSET of a (possibly sharded) fleet.

    Robots where `mask` (R,) is True are re-initialized from their row of
    `pose_pools` (R, M, 3) — the batched initWithPoseFn of the reference's
    global-localization service (node.cpp:870-883, particle_filter.cpp:
    136-162) — while the other robots' states (including PRNG keys) are
    left untouched. Implemented as a pure per-leaf where-select over the
    stacked state pytree, so it runs unchanged under shard_map with `mask`
    and `pose_pools` sharded along the fleet axis (no collectives).

    Masked robots consume one PRNG split; unmasked keep their old key, so
    an unmasked robot's trajectory is bit-identical to a run where the
    reinit never happened."""
    keys = jax.vmap(lambda k: jax.random.split(k)[0])(states.key)
    fresh = jax.vmap(
        lambda k, p: pf_filter.init_with_poses(
            params, k, p, alpha_slow, alpha_fast)
    )(keys, jnp.asarray(pose_pools, jnp.float32))

    def sel(old, new):
        m = mask.reshape(mask.shape + (1,) * (old.ndim - 1))
        return jnp.where(m, new, old)

    return jax.tree.map(sel, states, fresh)


def make_fleet_step(params: PFParams, odom_model=odom_models.OdomModel.DIFF,
                    laser_model="likelihood_field",
                    resample_model=ResampleModel.MULTINOMIAL):
    """Jitted single-device fleet step."""
    return jax.jit(
        functools.partial(
            fleet_step, params=params, odom_model=odom_model,
            laser_model=laser_model, resample_model=resample_model,
        )
    )


def make_sharded_fleet_step(
    mesh: Mesh,
    params: PFParams,
    axis: str = "fleet",
    odom_model=odom_models.OdomModel.DIFF,
    laser_model="likelihood_field",
    resample_model=ResampleModel.MULTINOMIAL,
):
    """The multi-device fleet step: robots sharded along `axis`, map
    replicated.

    Robots are independent, so the per-shard program is just the local
    vmapped step, with zero hot-path collectives. Requires the robot count
    to be a multiple of the mesh axis size.
    """
    local = functools.partial(
        fleet_step, params=params, odom_model=odom_model,
        laser_model=laser_model, resample_model=resample_model,
    )
    sharded = P(axis)
    replicated = P()
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(sharded, replicated, replicated, sharded, sharded,
                  sharded, sharded, sharded, replicated),
        out_specs=sharded,
        check_vma=False,
    )
    return jax.jit(fn)


def fleet_health(states, mesh: Optional[Mesh] = None, axis: str = "fleet"):
    """Cross-fleet aggregate: per-robot (converged, n_active, max cluster
    weight) plus fleet means — the one place a collective appears.
    Works on sharded or local states."""
    def summarize(states):
        w = jnp.max(states.stats.cluster_weights, axis=-1)
        return {
            "converged_frac": jnp.mean(states.converged.astype(jnp.float32)),
            "mean_active": jnp.mean(states.n_active.astype(jnp.float32)),
            "mean_top_weight": jnp.mean(w),
        }

    if mesh is None:
        return jax.jit(summarize)(states)

    def local(states):
        w = jnp.max(states.stats.cluster_weights, axis=-1)
        n = states.converged.shape[0]
        conv = jax.lax.psum(jnp.sum(states.converged.astype(jnp.float32)), axis)
        act = jax.lax.psum(jnp.sum(states.n_active.astype(jnp.float32)), axis)
        topw = jax.lax.psum(jnp.sum(w), axis)
        total = jax.lax.psum(jnp.float32(n), axis)
        return {
            "converged_frac": conv / total,
            "mean_active": act / total,
            "mean_top_weight": topw / total,
        }

    fn = shard_map(local, mesh=mesh, in_specs=(P(axis),), out_specs=P(),
                   check_vma=False)
    return jax.jit(fn)(states)
