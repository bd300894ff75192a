"""The particle filter core as pure functional transforms.

Re-expresses `ParticleFilter` (src/amcl/pf/particle_filter.cpp) over dense
`(M, 3)` pose arrays:

- `init_with_gaussian`   <- initWithGaussian (particle_filter.cpp:106-133)
- `init_with_poses`      <- initWithPoseFn (particle_filter.cpp:136-162)
- `sensor_update`        <- updateSensor incl. w_slow/w_fast augmented-MCL
                            running averages (particle_filter.cpp:223-267)
- `resample`             <- updateResample + resampleSystematic/Multinomial
                            with random-pose injection and the KLD population
                            bound (particle_filter.cpp:269-471)
- `update_converged`     <- updateConverged (particle_filter.cpp:170-220)

KLD adaptivity under static shapes: arrays stay at `max_samples` capacity and
a traced `n_active` masks the tail; the mid-stream KLD stop of the reference's
multinomial loop (break when sample_count > resampleLimit(leaf_count),
particle_filter.cpp:416) is reproduced exactly by drawing all `max_samples`
candidates up front (iid draws commute) and computing the stopping index from
the prefix-scan of first-occurrence bin flags.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from badger_amcl.ops import mxu_gather
from badger_amcl.pf import cluster, gaussian, kld
from badger_amcl.pf.types import ClusterStats, MCLState, PFParams


class ResampleModel(enum.IntEnum):
    """PFResampleModelType (particle_filter.h; default multinomial,
    particle_filter.cpp:46)."""

    MULTINOMIAL = 0
    SYSTEMATIC = 1


# ---------------------------------------------------------------------------
# Initialization


def _finalize_init(params, poses, key, alpha_slow, alpha_fast) -> MCLState:
    m = params.max_samples
    weights = jnp.full((m,), 1.0 / m, jnp.float32)
    active = jnp.ones((m,), bool)
    stats = cluster.compute_cluster_stats(poses, weights, active, params)
    return MCLState(
        poses=poses,
        weights=weights,
        n_active=jnp.int32(m),
        key=key,
        w_slow=jnp.float32(0.0),
        w_fast=jnp.float32(0.0),
        alpha_slow=jnp.float32(alpha_slow),
        alpha_fast=jnp.float32(alpha_fast),
        converged=jnp.array(False),  # initConverged (particle_filter.cpp:164-168)
        stats=stats,
    )


def init_with_gaussian(
    params: PFParams,
    key: jax.Array,
    mean,
    cov,
    alpha_slow: float = 0.001,
    alpha_fast: float = 0.1,
) -> MCLState:
    """initWithGaussian: max_samples poses from N(mean, cov), uniform weights,
    reset recovery averages, recompute cluster stats."""
    key, sub = jax.random.split(key)
    poses = gaussian.sample_poses(sub, jnp.asarray(mean), jnp.asarray(cov), params.max_samples)
    return _finalize_init(params, poses, key, alpha_slow, alpha_fast)


def init_with_poses(
    params: PFParams,
    key: jax.Array,
    poses: jnp.ndarray,
    alpha_slow: float = 0.001,
    alpha_fast: float = 0.1,
) -> MCLState:
    """initWithPoseFn: the caller supplies max_samples pre-drawn poses (the
    batched equivalent of calling the uniform pose generator per particle)."""
    assert poses.shape == (params.max_samples, 3)
    return _finalize_init(params, poses.astype(jnp.float32), key, alpha_slow, alpha_fast)


# ---------------------------------------------------------------------------
# Sensor update


def sensor_update(
    state: MCLState,
    p_model: jnp.ndarray,
    map_factor: Optional[jnp.ndarray] = None,
) -> MCLState:
    """Apply a measurement model's multiplicative particle likelihoods.

    p_model: (M,) per-particle likelihood combination from the sensor model
             (e.g. 1 + sum pz^3). Multiplied into the weights exactly as
             `sample->weight *= p` does in the model loops.
    map_factor: (M,) off-map / non-free-space penalty factors
             (recalcWeight, planar_scanner.cpp:642-682) — applied only when
             the model's total weight is positive, matching
             `if (rv > 0.0) rv = recalcWeight(set)` (planar_scanner.cpp:159-162).
             Passing the PRE-FOLDED product p*factor as p_model with
             map_factor=None is exactly equivalent: with p, factor >= 0
             (true of every model/factor), t1 == 0 implies every w*p == 0,
             so both formulations reach the same uniform reset, and when
             t1 > 0 the kept weights/total are the identical products.

    Then normalize and update the w_slow/w_fast augmented-MCL averages
    (particle_filter.cpp:237-266); zero total resets to uniform.
    """
    active = state.active_mask
    w1 = jnp.where(active, state.weights * p_model, 0.0)
    t1 = jnp.sum(w1)
    if map_factor is None:
        w2, t2 = w1, t1
    else:
        w2 = jnp.where(active, w1 * map_factor, 0.0)
        t2 = jnp.sum(w2)
    w_unnorm = jnp.where(t1 > 0.0, w2, w1)
    total = jnp.where(t1 > 0.0, t2, 0.0)

    n = state.n_active.astype(jnp.float32)
    w_avg = total / jnp.maximum(n, 1.0)
    new_wslow = jnp.where(
        state.w_slow == 0.0,
        w_avg,
        state.w_slow + state.alpha_slow * (w_avg - state.w_slow),
    )
    new_wfast = jnp.where(
        state.w_fast == 0.0,
        w_avg,
        state.w_fast + state.alpha_fast * (w_avg - state.w_fast),
    )

    uniform = jnp.where(active, 1.0 / jnp.maximum(n, 1.0), 0.0)
    ok = total > 0.0
    new_weights = jnp.where(ok, w_unnorm / jnp.where(ok, total, 1.0), uniform)
    return state.replace(
        weights=new_weights.astype(jnp.float32),
        w_slow=jnp.where(ok, new_wslow, state.w_slow),
        w_fast=jnp.where(ok, new_wfast, state.w_fast),
    )


# ---------------------------------------------------------------------------
# Log-space-resident sensor update (likelihood_field_prob at high beam counts)
#
# The prob model's per-particle weight is a PRODUCT of up to B beam
# probabilities (planar_scanner.cpp:325-533). In f32 that underflows past
# ~60 beams (every p flushes to 0, total weight 0, and the filter uniform-
# resets forever) — faithful to how the f64 reference degrades at ~600+
# beams, but useless at the 720-beam scans of a modern laser. The log-space pipeline keeps
# per-particle LOG weights through normalization (log-sum-exp), stores the
# w_slow/w_fast recovery averages in LOG domain (their EMA recursion is a
# positive combination, so it is a logaddexp), and hands resampling
# NORMALIZED linear weights (exp(logw - lse) cannot overflow; weights below
# f32's tiny threshold are genuinely negligible). Reference behavior at
# reference beam counts stays the default exp path, bit-for-bit.

# w_slow/w_fast "uninitialized" sentinel in log domain (reference uses 0.0
# in linear domain, particle_filter.cpp:246-255; log w_avg is always finite
# or -inf, and +inf is unreachable, so it is a safe sentinel).
LOG_UNINIT = jnp.float32(jnp.inf)


def _logaddexp(a, b):
    m = jnp.maximum(a, b)
    d = -jnp.abs(a - b)
    out = m + jnp.log1p(jnp.exp(d))
    return jnp.where(jnp.isinf(m), m, out)


def sensor_update_log(
    state: MCLState,
    log_p: jnp.ndarray,
    map_factor: Optional[jnp.ndarray] = None,
) -> MCLState:
    """`sensor_update` with per-particle LOG likelihoods (the prob model's
    natural output). state.w_slow/w_fast hold LOG-domain averages under
    this contract (initialize with init_log_averages / LOG_UNINIT); pair
    with resample(log_averages=True)."""
    active = state.active_mask
    neg_inf = jnp.float32(-jnp.inf)
    logw_prev = jnp.where(
        active & (state.weights > 0), jnp.log(state.weights), neg_inf
    )
    lw = logw_prev + log_p
    if map_factor is not None:
        lw = lw + jnp.log(map_factor)
    lse = jax.scipy.special.logsumexp(jnp.where(active, lw, neg_inf))

    n = state.n_active.astype(jnp.float32)
    log_wavg = lse - jnp.log(jnp.maximum(n, 1.0))
    la_s = jnp.log(state.alpha_slow)
    la_f = jnp.log(state.alpha_fast)
    l1m_s = jnp.log1p(-state.alpha_slow)
    l1m_f = jnp.log1p(-state.alpha_fast)
    new_wslow = jnp.where(
        state.w_slow == LOG_UNINIT,
        log_wavg,
        _logaddexp(l1m_s + state.w_slow, la_s + log_wavg),
    )
    new_wfast = jnp.where(
        state.w_fast == LOG_UNINIT,
        log_wavg,
        _logaddexp(l1m_f + state.w_fast, la_f + log_wavg),
    )

    ok = jnp.isfinite(lse)  # all-(-inf) == the reference's zero-total reset
    uniform = jnp.where(active, 1.0 / jnp.maximum(n, 1.0), 0.0)
    new_weights = jnp.where(
        ok, jnp.where(active, jnp.exp(lw - lse), 0.0), uniform
    )
    return state.replace(
        weights=new_weights.astype(jnp.float32),
        w_slow=jnp.where(ok, new_wslow, state.w_slow),
        w_fast=jnp.where(ok, new_wfast, state.w_fast),
    )


def init_log_averages(state: MCLState) -> MCLState:
    """Reset w_slow/w_fast to the log-domain uninitialized sentinel (the
    log twin of initializing them to 0.0)."""
    return state.replace(w_slow=LOG_UNINIT, w_fast=LOG_UNINIT)


# ---------------------------------------------------------------------------
# Convergence


def update_converged(state: MCLState, params: PFParams,
                     mean_xy=None) -> MCLState:
    """updateConverged (particle_filter.cpp:170-220): fraction of particles
    within dist_threshold (L-inf, 0.5 m) of the unweighted x/y mean.

    mean_xy: optional precomputed (2,) unweighted active mean — resample
    passes the fresh cluster stats' set mean (weights are uniform
    post-resample, so the weighted set mean IS the unweighted one, up to
    f32 reassociation), saving two 50k reductions per step."""
    active = state.active_mask
    n = jnp.maximum(state.n_active.astype(jnp.float32), 1.0)
    if mean_xy is not None:
        mx, my = mean_xy[0], mean_xy[1]
    else:
        mx = jnp.sum(jnp.where(active, state.poses[:, 0], 0.0)) / n
        my = jnp.sum(jnp.where(active, state.poses[:, 1], 0.0)) / n
    within = (
        (jnp.abs(state.poses[:, 0] - mx) <= params.dist_threshold)
        & (jnp.abs(state.poses[:, 1] - my) <= params.dist_threshold)
        & active
    )
    pct = 100.0 * jnp.sum(within).astype(jnp.float32) / n
    return state.replace(converged=pct >= params.convergence_threshold)


# ---------------------------------------------------------------------------
# Resampling


def _pick_indices(weights, r):
    """Discrete-event sampling: index i such that cum[i-1] <= r < cum[i]
    (the linear scans at particle_filter.cpp:312-315,394-398).

    Implemented as a two-level branchless search (chunk-boundary compares
    plus a one-hot row pick) instead of jnp.searchsorted; whether that
    still pays on the GPU is an open measurement (ROADMAP.md Queue 1).
    Exactly equivalent to searchsorted(cum, r, side='right')."""
    n = weights.shape[0]
    cum = jnp.cumsum(weights)
    chunk = 128
    n_pad = -(-n // chunk) * chunk
    n_chunks = n_pad // chunk
    # finite pad sentinel: inf would make the 0 * inf products in the one-hot
    # contraction NaN; cum <= 1 so 2.0 sorts after every real value
    cum_pad = jnp.full((n_pad,), 2.0, cum.dtype).at[:n].set(cum)
    cum2d = cum_pad.reshape(n_chunks, chunk)
    # level 1: which chunk? count chunk-ends <= r  (side='right' semantics)
    ends = cum2d[:, -1]
    ci = jnp.sum(r[:, None] >= ends[None, :], axis=1).astype(jnp.int32)
    ci = jnp.clip(ci, 0, n_chunks - 1)
    # level 2: fetch each query's chunk by one-hot contraction, then
    # count in-chunk values <= r
    onehot = (ci[:, None] == jnp.arange(n_chunks)[None, :]).astype(cum.dtype)
    rows = jax.lax.dot_general(
        onehot, cum2d, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=cum.dtype,
        # HIGHEST (full f32, not TF32/bf16): a truncated cum value would
        # shift the in-chunk count when adjacent weights are close.
        precision=jax.lax.Precision.HIGHEST,
    )  # (Q, chunk)
    within = jnp.sum(r[:, None] >= rows, axis=1).astype(jnp.int32)
    idx = ci * chunk + within
    return jnp.clip(idx, 0, n - 1)


def _resample_multinomial(
    state: MCLState, params: PFParams, w_diff, random_pose_pool, key
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """resampleMultinomial (particle_filter.cpp:356-420): iid draws with
    per-draw random-pose injection (prob w_diff) and the mid-stream KLD stop.

    Returns (new_poses (M, 3), new_count scalar int32)."""
    m = params.max_samples
    k1, k2 = jax.random.split(key)
    use_random = jax.random.uniform(k1, (m,)) < w_diff
    r = jax.random.uniform(k2, (m,))
    idx = _pick_indices(state.weights, r)
    picked = mxu_gather.gather_rows(state.poses, idx)
    new_poses = jnp.where(use_random[:, None], random_pose_pool, picked)

    # Stop index: first n (1-based) with n > resampleLimit(bins among first n)
    ones = jnp.ones((m,), bool)
    _, flat = kld.grid_cells(kld.bin_keys(new_poses), ones, params.hist_shape)
    if params.stats_max_clusters:
        # fleet path: grid scatter-min (sorts lower poorly under vmap)
        is_new = kld.first_occurrence_flags(flat, ones, params.hist_shape)
    else:
        is_new = kld.first_occurrence_flags_sorted(flat, ones)
    k_n = jnp.cumsum(is_new.astype(jnp.int32))
    limit_n = kld.resample_limit(
        k_n, params.min_samples, params.max_samples, params.pop_err, params.pop_z
    )
    n_1based = jnp.arange(1, m + 1, dtype=jnp.int32)
    stop = n_1based > limit_n
    new_count = jnp.where(jnp.any(stop), jnp.argmax(stop).astype(jnp.int32) + 1, m)
    return new_poses, new_count


def _resample_multinomial_fused(state, params, w_diff, random_pose_pool, key):
    """_resample_multinomial + the cluster-rank machinery of
    compute_cluster_stats fused over ONE bin sort of the new candidate set
    (the post-resample stats re-sorted the very same poses; sharing saves
    two 50k-element multi-operand sorts and a grid pass per step).

    Returns (new_poses, new_count, rank_p, cluster_count)."""
    m = params.max_samples
    k1, k2 = jax.random.split(key)
    use_random = jax.random.uniform(k1, (m,)) < w_diff
    r = jax.random.uniform(k2, (m,))
    idx = _pick_indices(state.weights, r)
    picked = mxu_gather.gather_rows(state.poses, idx)
    new_poses = jnp.where(use_random[:, None], random_pose_pool, picked)
    new_count, rank_p, cluster_count = _kld_stop_and_ranks(new_poses, params)
    return new_poses, new_count, rank_p, cluster_count


def _kld_stop_and_ranks(new_poses, params):
    """Mid-stream KLD stop + cluster-rank machinery over a full (M, 3)
    resample candidate set in draw order.

    Semantics match the separate prefix-scan + compute_cluster_stats path
    exactly, with two documented differences confined to conservative-
    approximation territory:
    - the stats bin grid is positioned at the min bin over ALL max_samples
      candidates (the KLD stop always used that origin) instead of the
      active subset's min — identical unless the candidate spread exceeds
      the hist-grid budget (>127 m at defaults), where clamp-merging is
      the documented degradation either way (kld.py module docstring);
    - with more than MAX_UNIQUE_BINS occupied bins the big arm computes the
      stop exactly as before and takes the grid rank path.
    The mid-stream KLD stop (particle_filter.cpp:416) is reproduced from
    the sorted new-bin event times: k_n == j exactly for
    n in [D_j + 1, D_{j+1}] where D_j is the j-th smallest first-occurrence
    draw index, so the first n with n > resampleLimit(k_n) is
    min_j max(D_j + 1, limit(j) + 1) clipped to that interval — verified
    equal to the prefix-scan formulation by tests/test_resample_oracle.py."""
    m = params.max_samples
    ones = jnp.ones((m,), bool)
    _, flat = kld.grid_cells(kld.bin_keys(new_poses), ones, params.hist_shape)
    draw = jnp.arange(m, dtype=jnp.int32)
    ks, idx_s = jax.lax.sort((flat, draw), num_keys=1, is_stable=True)
    segstart = jnp.concatenate([jnp.ones((1,), bool), ks[1:] != ks[:-1]])
    u_count = jnp.sum(segstart).astype(jnp.int32)
    u = min(cluster.MAX_UNIQUE_BINS, m)

    def small_arm(_):
        # compact unique bins to the front (ascending) with each bin's
        # minimum draw index (stability: the segstart entry IS the min)
        pk = jnp.where(segstart, 0, 1).astype(jnp.int32)
        _, ks_c, d_c = jax.lax.sort(
            (pk, ks, idx_s), num_keys=1, is_stable=True
        )
        uk = ks_c[:u]
        dmin = d_c[:u]
        front = jnp.arange(u, dtype=jnp.int32) < u_count
        # mid-stream stop from sorted new-bin event times (docstring above)
        d_sorted = jnp.sort(jnp.where(front, dmin, m))
        kj = jnp.arange(1, u + 1, dtype=jnp.int32)
        limit_j = kld.resample_limit(
            kj, params.min_samples, params.max_samples,
            params.pop_err, params.pop_z,
        )
        d_next = jnp.concatenate(
            [d_sorted[1:], jnp.full((1,), m, jnp.int32)]
        )
        n0 = jnp.maximum(d_sorted + 1, limit_j + 1)
        cand = jnp.where(n0 <= d_next, n0, m + 1)
        new_count = jnp.minimum(jnp.min(cand), m).astype(jnp.int32)
        # cluster ranks among ACTIVE bins only: a bin holds an active
        # particle iff its minimum draw index beat the stop
        act_bin = front & (dmin < new_count)
        rank_u, cluster_count = cluster._ranks_from_unique(
            uk, act_bin, params.hist_shape
        )
        segid = jnp.cumsum(segstart.astype(jnp.int32)) - 1
        rank_s = mxu_gather.broadcast_small(
            rank_u.astype(jnp.float32), jnp.clip(segid, 0, u - 1)
        ).astype(jnp.int32)
        _, rank_d = jax.lax.sort((idx_s, rank_s), num_keys=1, is_stable=True)
        return new_count, rank_d, cluster_count

    def big_arm(_):
        # spread beyond MAX_UNIQUE_BINS: exact draw-order flags (any K)
        # + the grid rank path
        _, flags = jax.lax.sort(
            (idx_s, segstart.astype(jnp.int32)), num_keys=1, is_stable=True
        )
        k_n = jnp.cumsum(flags)
        limit_n = kld.resample_limit(
            k_n, params.min_samples, params.max_samples,
            params.pop_err, params.pop_z,
        )
        n_1based = jnp.arange(1, m + 1, dtype=jnp.int32)
        stop = n_1based > limit_n
        new_count = jnp.where(
            jnp.any(stop), jnp.argmax(stop).astype(jnp.int32) + 1, m
        )
        active = draw < new_count
        rank_p, cluster_count = cluster._ranks_grid_path(
            jnp.where(active, flat, 0), active, params.hist_shape
        )
        return new_count, rank_p, cluster_count

    return jax.lax.cond(
        u_count <= u, small_arm, big_arm, operand=None
    )


def _resample_systematic(
    state: MCLState, params: PFParams, w_diff, random_pose_pool, key
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """resampleSystematic (particle_filter.cpp:269-354): target count from the
    *previous* set's leaf count, inflated by w_diff for random injection,
    low-variance comb over the cumulative weights for the rest."""
    m = params.max_samples
    if params.stats_max_clusters:
        k_old = kld.leaf_count(state.poses, state.active_mask, params.hist_shape)
    else:
        k_old = kld.leaf_count_sorted(
            state.poses, state.active_mask, params.hist_shape)
    base_count = kld.resample_limit(
        k_old, params.min_samples, params.max_samples, params.pop_err, params.pop_z
    )
    inflated = jnp.minimum(
        jnp.int32(m), (base_count.astype(jnp.float32) * (1.0 + w_diff)).astype(jnp.int32)
    )  # C++ int conversion truncates (particle_filter.cpp:296-303)
    new_count = jnp.where(w_diff > 0.0, inflated, base_count)
    num_random = (w_diff * new_count.astype(jnp.float32)).astype(jnp.int32)
    num_sys = jnp.maximum(new_count - num_random, 1)

    start = jax.random.uniform(key, ())
    delta = 1.0 / num_sys.astype(jnp.float32)
    i = jnp.arange(m, dtype=jnp.int32)
    t = jnp.mod(start + (i - num_random).astype(jnp.float32) * delta, 1.0)
    idx = _pick_indices(state.weights, t)
    picked = mxu_gather.gather_rows(state.poses, idx)
    new_poses = jnp.where((i < num_random)[:, None], random_pose_pool, picked)
    return new_poses, new_count


def resample(
    state: MCLState,
    params: PFParams,
    random_pose_pool: jnp.ndarray,
    model: ResampleModel = ResampleModel.MULTINOMIAL,
    log_averages: bool = False,
) -> MCLState:
    """updateResample (particle_filter.cpp:423-471).

    random_pose_pool: (M, 3) pre-drawn candidate random poses (the batched
    random_pose_fn; see node.random_pose_pool). Consumed only as far as the
    injection count requires.

    log_averages (static): w_slow/w_fast hold LOG-domain averages (the
    sensor_update_log contract) — w_diff becomes 1 - exp(w_fast - w_slow)
    and the recovery reset restores the log-domain sentinel."""
    key, sub = jax.random.split(state.key)
    if log_averages:
        ok_ws = jnp.isfinite(state.w_slow) & (state.w_slow != LOG_UNINIT)
        w_diff = jnp.where(
            ok_ws,
            jnp.maximum(
                0.0,
                1.0 - jnp.exp(
                    state.w_fast - jnp.where(ok_ws, state.w_slow, 0.0)
                ),
            ),
            0.0,
        )
    else:
        # w_diff = max(0, 1 - w_fast/w_slow); guard w_slow == 0 (the
        # reference would produce NaN there, which its comparisons treat as
        # 0 — we make the equivalence explicit).
        w_diff = jnp.where(
            state.w_slow > 0.0,
            jnp.maximum(0.0, 1.0 - state.w_fast / jnp.where(state.w_slow > 0, state.w_slow, 1.0)),
            0.0,
        )

    ranks = None
    if model == ResampleModel.SYSTEMATIC:
        new_poses, new_count = _resample_systematic(
            state, params, w_diff, random_pose_pool, sub
        )
    elif params.stats_max_clusters:
        # fleet path (vmapped): keep the grid formulations separate
        new_poses, new_count = _resample_multinomial(
            state, params, w_diff, random_pose_pool, sub
        )
    else:
        new_poses, new_count, rank_p, cluster_count = (
            _resample_multinomial_fused(
                state, params, w_diff, random_pose_pool, sub
            )
        )
        ranks = (rank_p, cluster_count)

    m = params.max_samples
    active = jnp.arange(m) < new_count
    weights = jnp.where(active, 1.0 / new_count.astype(jnp.float32), 0.0)

    # Reset averages to avoid spiraling into randomness (particle_filter.cpp:453-455)
    reset = w_diff > 0.0
    uninit = LOG_UNINIT if log_averages else jnp.float32(0.0)
    new_state = state.replace(
        poses=new_poses.astype(jnp.float32),
        weights=weights.astype(jnp.float32),
        n_active=new_count.astype(jnp.int32),
        key=key,
        w_slow=jnp.where(reset, uninit, state.w_slow),
        w_fast=jnp.where(reset, uninit, state.w_fast),
    )
    stats = cluster.compute_cluster_stats(
        new_state.poses, new_state.weights, new_state.active_mask, params,
        precomputed_ranks=ranks,
    )
    new_state = new_state.replace(stats=stats)
    return update_converged(new_state, params, mean_xy=stats.mean[:2])


# ---------------------------------------------------------------------------
# Introspection helpers (getClusterStats / getMaxWeightPose equivalents)


def max_weight_cluster(stats: ClusterStats):
    """Argmax-weight cluster's (weight, mean) — the published pose hypothesis
    (getMaxWeightPose, node_2d.cpp:588-617)."""
    cidx = jnp.argmax(stats.cluster_weights)
    return stats.cluster_weights[cidx], stats.cluster_means[cidx]
