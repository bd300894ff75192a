"""Fused multinomial resample + cluster ranks (pf.filter._resample_multinomial_fused)
vs the separate formulation it replaces.

Contract: identical picks, identical mid-stream KLD stop count (the
interval reformulation must EQUAL the prefix-scan one), and identical
cluster ranks / counts / statistics for the clouds where the grid origins
coincide (everything but >127 m candidate spreads — kld.py docstring)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from badger_amcl.pf import cluster, filter as pf_filter, kld
from badger_amcl.pf.types import PFParams


def _state(m, seed, spread):
    params = PFParams(min_samples=max(8, m // 32), max_samples=m)
    key = jax.random.PRNGKey(seed)
    st = pf_filter.init_with_gaussian(
        params, key, jnp.zeros(3),
        jnp.diag(jnp.array([spread, spread, spread * 0.2])))
    # non-uniform weights so picks matter
    w = jax.random.uniform(jax.random.PRNGKey(seed + 7), (m,)) + 0.01
    st = st.replace(weights=(w / jnp.sum(w)).astype(jnp.float32))
    return params, st


def _old_path(state, params, w_diff, pool, key):
    """The pre-fusion composition: separate multinomial resample, then
    compute_cluster_stats re-binning the new poses."""
    new_poses, new_count = pf_filter._resample_multinomial(
        state, params, w_diff, pool, key)
    m = params.max_samples
    active = jnp.arange(m) < new_count
    weights = jnp.where(active, 1.0 / new_count.astype(jnp.float32), 0.0)
    stats = cluster.compute_cluster_stats(new_poses, weights, active, params)
    return new_poses, new_count, stats


@pytest.mark.parametrize("m,spread,w_diff,seed", [
    (512, 0.02, 0.0, 0),
    (512, 0.02, 0.3, 1),
    (4096, 0.5, 0.0, 2),
    (4096, 2.0, 0.25, 3),
    (333, 5.0, 0.5, 4),   # non-multiple-of-128 m, wide cloud
])
def test_fused_matches_separate(m, spread, w_diff, seed):
    params, state = _state(m, seed, spread)
    pool = jax.random.uniform(
        jax.random.PRNGKey(seed + 13), (m, 3), minval=-8.0, maxval=8.0)
    key = jax.random.PRNGKey(seed + 99)

    new_poses, new_count, rank_p, ccount = (
        pf_filter._resample_multinomial_fused(
            state, params, jnp.float32(w_diff), pool, key))
    old_poses, old_count, old_stats = _old_path(
        state, params, jnp.float32(w_diff), pool, key)

    np.testing.assert_array_equal(np.asarray(new_poses), np.asarray(old_poses))
    assert int(new_count) == int(old_count)
    assert int(ccount) == int(old_stats.cluster_count)
    active = np.arange(m) < int(new_count)
    np.testing.assert_array_equal(
        np.asarray(rank_p)[active],
        np.asarray(old_stats.particle_cluster)[active])
    # full stats through resample() must match the old composition too
    weights = jnp.where(jnp.asarray(active),
                        1.0 / jnp.float32(int(new_count)), 0.0)
    stats = cluster.compute_cluster_stats(
        new_poses, weights, jnp.asarray(active), params,
        precomputed_ranks=(rank_p, ccount))
    np.testing.assert_allclose(np.asarray(stats.cluster_means),
                               np.asarray(old_stats.cluster_means),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(stats.cluster_weights),
                               np.asarray(old_stats.cluster_weights),
                               atol=1e-7)


def test_fused_big_arm_matches(monkeypatch):
    """Force the > MAX_UNIQUE_BINS arm (spread beyond the compaction
    capacity) and check it still equals the separate path."""
    monkeypatch.setattr(cluster, "MAX_UNIQUE_BINS", 64)
    m = 512
    params, state = _state(m, 5, 8.0)  # wide cloud -> many unique bins
    pool = jax.random.uniform(
        jax.random.PRNGKey(21), (m, 3), minval=-8.0, maxval=8.0)
    key = jax.random.PRNGKey(22)
    new_poses, new_count, rank_p, ccount = (
        pf_filter._resample_multinomial_fused(
            state, params, jnp.float32(0.1), pool, key))
    old_poses, old_count, old_stats = _old_path(
        state, params, jnp.float32(0.1), pool, key)
    assert int(new_count) == int(old_count)
    active = np.arange(m) < int(new_count)
    np.testing.assert_array_equal(
        np.asarray(rank_p)[active],
        np.asarray(old_stats.particle_cluster)[active])
    assert int(ccount) == int(old_stats.cluster_count)
