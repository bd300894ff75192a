"""Resampling parity against literal numpy transcriptions of the reference
loops, fed identical random draws.

The JAX resamplers reformulate the reference's sequential loops
(particle_filter.cpp:269-420) as prefix-scan programs; these tests prove the
reformulation picks the *same particles* and stops at the *same KLD count*
given the same uniform variates, not merely the same distribution.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np

from badger_amcl.pf import kld
from badger_amcl.pf.filter import _pick_indices
from badger_amcl.pf.types import PFParams
import pytest

HIST = (64, 64, 40)


def _ref_resample_limit(k, min_s, max_s, pop_err, pop_z):
    if k <= 1:
        return max_s
    b = 2.0 / (9.0 * (k - 1))
    c = math.sqrt(b) * pop_z
    x = 1.0 - b + c
    n = int(math.ceil((k - 1) / (2.0 * pop_err) * x * x * x))
    return min(max(n, min_s), max_s)


def _ref_multinomial(weights, poses, rs, use_random, random_poses,
                     min_s, max_s, pop_err, pop_z):
    """Literal resampleMultinomial (particle_filter.cpp:356-420) with
    injected variates: rs[i] the categorical draw, use_random[i] the
    injection decision. Returns (picked poses, count)."""
    c = np.concatenate([[0.0], np.cumsum(weights)])
    out = []
    bins = set()
    count = 0
    while count < max_s:
        if use_random[count]:
            pose = random_poses[count]
        else:
            r = rs[count]
            i = int(np.searchsorted(c, r, side="right")) - 1
            i = min(max(i, 0), len(weights) - 1)
            pose = poses[i]
        out.append(pose)
        key = tuple(np.floor(pose / np.array([0.5, 0.5, np.pi / 18])).astype(int))
        bins.add(key)
        count += 1
        if count > _ref_resample_limit(len(bins), min_s, max_s, pop_err, pop_z):
            break
    return np.array(out), count


@pytest.mark.slow
def test_multinomial_matches_reference_sequence():
    rng = np.random.default_rng(0)
    m = 512
    min_s, max_s = 16, m
    pop_err, pop_z = 0.05, 3.0
    poses = rng.normal(0, 1.2, (m, 3)).astype(np.float32)
    w = rng.random(m).astype(np.float32)
    w /= w.sum()
    rs = rng.random(m).astype(np.float32)
    use_random = rng.random(m) < 0.15
    random_poses = rng.uniform(-4, 4, (m, 3)).astype(np.float32)

    # reference transcription
    want_poses, want_count = _ref_multinomial(
        np.asarray(jnp.cumsum(jnp.asarray(w)) - jnp.cumsum(jnp.asarray(w)) + w),
        poses, rs, use_random, random_poses, min_s, max_s, pop_err, pop_z,
    )

    # vectorized reformulation with the same variates
    idx = np.asarray(_pick_indices(jnp.asarray(w), jnp.asarray(rs)))
    new_poses = np.where(use_random[:, None], random_poses, poses[idx])
    ones = jnp.ones((m,), bool)
    _, flat = kld.grid_cells(kld.bin_keys(jnp.asarray(new_poses)), ones, HIST)
    is_new = np.asarray(kld.first_occurrence_flags(flat, ones, HIST))
    k_n = np.cumsum(is_new)
    limit = np.asarray(
        kld.resample_limit(jnp.asarray(k_n), min_s, max_s, pop_err, pop_z)
    )
    stop = np.arange(1, m + 1) > limit
    got_count = int(np.argmax(stop)) + 1 if stop.any() else m

    assert got_count == want_count
    np.testing.assert_allclose(new_poses[:got_count], want_poses, atol=1e-6)


def _ref_systematic(weights, poses, start, w_diff, random_poses,
                    min_s, max_s, pop_err, pop_z, leaf_count):
    """Literal resampleSystematic (particle_filter.cpp:269-354)."""
    c = np.concatenate([[0.0], np.cumsum(weights, dtype=np.float64)])
    new_count = _ref_resample_limit(leaf_count, min_s, max_s, pop_err, pop_z)
    if w_diff > 0.0:
        new_count = min(max_s, int(new_count * (1.0 + w_diff)))
    num_random = int(w_diff * new_count)
    num_sys = new_count - num_random
    delta = 1.0 / num_sys
    out = list(random_poses[:num_random])
    c_i = 0
    while not (c[c_i] <= start < c[c_i + 1]):
        c_i += 1
    target = start
    for _ in range(num_sys):
        while not (c[c_i] <= target < c[c_i + 1]):
            c_i += 1
            if c_i >= len(weights):
                c_i = 0
        target += delta
        if target > 1.0:
            target -= 1.0
        out.append(poses[c_i])
    return np.array(out), new_count


def test_systematic_matches_reference_sequence():
    rng = np.random.default_rng(1)
    m = 256
    min_s, max_s = 16, m
    pop_err, pop_z = 0.05, 3.0
    poses = rng.normal(0, 1.0, (m, 3)).astype(np.float32)
    w = rng.random(m).astype(np.float64)
    w /= w.sum()
    start = 0.37
    w_diff = 0.2
    random_poses = rng.uniform(-4, 4, (m, 3)).astype(np.float32)

    leaf = int(kld.leaf_count(jnp.asarray(poses), jnp.ones((m,), bool), HIST))
    want_poses, want_count = _ref_systematic(
        w, poses, start, w_diff, random_poses, min_s, max_s, pop_err, pop_z, leaf
    )

    # vectorized: same formulas (filter._resample_systematic's core math)
    base = _ref_resample_limit(leaf, min_s, max_s, pop_err, pop_z)
    new_count = min(m, int(base * (1.0 + w_diff)))
    num_random = int(w_diff * new_count)
    num_sys = new_count - num_random
    i = np.arange(m)
    t = np.mod(start + (i - num_random) * (1.0 / num_sys), 1.0)
    idx = np.asarray(_pick_indices(jnp.asarray(w, jnp.float32), jnp.asarray(t, jnp.float32)))
    got = np.where((i < num_random)[:, None], random_poses, poses[idx])[:new_count]

    assert new_count == want_count
    # the reference walks the cumulative table in f64; matching picks exactly
    # requires identical arithmetic, so compare the *selected particles*
    # allowing boundary-tie divergence on at most a few slots
    mismatches = (~np.isclose(got, want_poses, atol=1e-6).all(axis=1)).sum()
    assert mismatches <= max(2, new_count // 100), mismatches
