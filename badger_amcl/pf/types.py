"""Particle filter state and static parameters.

The reference's mutable double-buffered `PFSampleSet` pair
(particle_filter.h:70-87, particle_filter.cpp:62-89) becomes one immutable
pytree: dense pose/weight arrays at a static `max_samples` capacity with a
traced `n_active` count (KLD adaptivity under static shapes — the tail is
masked out by zero weights). Double buffering is free in a functional style.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from badger_amcl.utils.pytree import pytree_dataclass, static_field


@pytree_dataclass
class PFParams:
    """Static filter parameters (hashable; changing them recompiles).

    Mirrors ParticleFilter ctor args + setPopulationSizeParameters
    (particle_filter.cpp:38-98,651-655).
    """

    min_samples: int = static_field(default=100)
    max_samples: int = static_field(default=5000)
    pop_err: float = static_field(default=0.01)
    pop_z: float = static_field(default=3.0)
    dist_threshold: float = static_field(default=0.5)
    # percent of particles within dist_threshold of the mean needed to declare
    # convergence (ctor arg global_localization_convergence_threshold)
    convergence_threshold: float = static_field(default=95.0)
    # dense KLD-histogram grid extents (bins of 0.5 m / 0.5 m / 10 deg; see
    # kld.py). Defaults cover a 63 m x 63 m particle spread and the full yaw
    # circle; spreads beyond that clamp into border bins (conservative).
    hist_x: int = static_field(default=128)
    hist_y: int = static_field(default=128)
    hist_a: int = static_field(default=40)
    # Cluster-statistics accumulation strategy. 0 (default, single-robot):
    # one-hot contraction when <= 128 live clusters, exact segment_sum
    # fallback beyond. > 0: one-hot ONLY, capped at this many clusters —
    # clusters past the cap keep their particles and weights but drop out
    # of the per-cluster statistics; it also selects the grid (not sorted)
    # KLD formulation. Use for fleet configs: under vmap a lax.cond lowers
    # to select and BOTH branches execute, so the segment_sum fallback
    # would run for every robot while never being taken (tracking robots
    # have 1-5 clusters).
    stats_max_clusters: int = static_field(default=0)

    @property
    def hist_shape(self):
        return (self.hist_x, self.hist_y, self.hist_a)


@pytree_dataclass
class ClusterStats:
    """Per-cluster and whole-set statistics (PFCluster / PFSampleSet fields,
    particle_filter.h:52-87). Cluster arrays are segment-indexed with capacity
    max_samples; `cluster_count` gives the number of live clusters and
    `cluster_valid` marks live segment ids."""

    cluster_count: jnp.ndarray  # int32 scalar
    cluster_valid: jnp.ndarray  # (M,) bool — segment id holds a live cluster
    cluster_weights: jnp.ndarray  # (M,) f32 summed normalized weights
    cluster_counts: jnp.ndarray  # (M,) int32 particle counts
    cluster_means: jnp.ndarray  # (M, 3) f32 (x, y, circular-mean yaw)
    cluster_covs: jnp.ndarray  # (M, 3, 3) f32 (xy block + circular var at [2,2])
    mean: jnp.ndarray  # (3,) f32 whole-set mean
    cov: jnp.ndarray  # (3, 3) f32 whole-set covariance
    particle_cluster: jnp.ndarray  # (M,) int32 segment id per particle


@pytree_dataclass
class MCLState:
    """The filter state. All arrays are device-resident and sized to
    params.max_samples; entries at index >= n_active are inactive."""

    poses: jnp.ndarray  # (M, 3) f32 (x, y, yaw)
    weights: jnp.ndarray  # (M,) f32, normalized over active, 0 for inactive
    n_active: jnp.ndarray  # int32 scalar
    key: jax.Array  # PRNG key
    w_slow: jnp.ndarray  # f32 scalar — augmented-MCL slow average
    w_fast: jnp.ndarray  # f32 scalar — augmented-MCL fast average
    alpha_slow: jnp.ndarray  # f32 scalar decay rate (setDecayRates is dynamic)
    alpha_fast: jnp.ndarray
    converged: jnp.ndarray  # bool scalar
    stats: ClusterStats

    @property
    def active_mask(self) -> jnp.ndarray:
        m = self.poses.shape[0]
        return jnp.arange(m) < self.n_active


def empty_cluster_stats(max_samples: int) -> ClusterStats:
    m = max_samples
    return ClusterStats(
        cluster_count=jnp.zeros((), jnp.int32),
        cluster_valid=jnp.zeros((m,), bool),
        cluster_weights=jnp.zeros((m,), jnp.float32),
        cluster_counts=jnp.zeros((m,), jnp.int32),
        cluster_means=jnp.zeros((m, 3), jnp.float32),
        cluster_covs=jnp.zeros((m, 3, 3), jnp.float32),
        mean=jnp.zeros((3,), jnp.float32),
        cov=jnp.zeros((3, 3), jnp.float32),
        particle_cluster=jnp.zeros((m,), jnp.int32),
    )
