"""Connected-component clustering of occupied pose-histogram bins and
cluster/set statistics.

The reference flood-fills the kd-tree: two bins belong to one cluster when
their keys are within the 3x3x3 neighborhood (pf_kdtree.cpp:58-76,169-194),
and statistics accumulate per cluster with circular yaw means
(particle_filter.cpp:505-636).

Grid design: the occupied bins live in a dense 3D grid (see kld.py).
Component labels start as each occupied cell's own flat index and diffuse by
*separable 3x3x3 min-dilation* — three axis passes of min(g, roll(g, +-1)),
six rolls per sweep, masked back to occupied cells — iterated under a
`lax.while_loop` until fixpoint. Rolls are contiguous vector moves, so the
whole clustering is scatter + rolls + elementwise: no sort, no searchsorted,
no per-element gather loops.

Label compaction to dense segment ids uses a cumulative sum of root flags
over the grid — again O(cells) vector work.

Cluster *numbering* differs from the reference (ours is by grid-cell rank,
the reference's by DFS discovery order); the set of clusters and their
weights/means/covariances — the quantities that determine the published pose
(getMaxWeightPose, node_2d.cpp:588-617) — are identical.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from badger_amcl.pf import kld
from badger_amcl.pf.types import ClusterStats

# Fast-path capacity for the one-hot segment sums; clouds with more live
# clusters than this use the scalar segment_sum fallback.
MAX_FAST_CLUSTERS = 128


def _box_min(g3):
    """Separable 3x3x3 minimum (Moore neighborhood incl. self) via rolls.

    The 1-cell empty border maintained by kld.grid_cells keeps roll wrap-around
    from leaking labels across the grid."""
    for axis in range(3):
        g3 = jnp.minimum(
            g3, jnp.minimum(jnp.roll(g3, 1, axis=axis), jnp.roll(g3, -1, axis=axis))
        )
    return g3


def _cluster_grid(occ_flat, shape):
    """Label the occupied-bin grid by connected component (26-neighborhood).

    occ_flat: bool (gx*gy*ga,). Returns int32 flat label grid where occupied
    cells hold their component's minimum flat cell index and empty cells hold
    BIG."""
    gx, gy, ga = shape
    n = gx * gy * ga
    occ3 = occ_flat.reshape(ga, gx, gy)  # (a, x, y) packing, see kld.grid_cells
    init = jnp.where(occ3, jnp.arange(n, dtype=jnp.int32).reshape(ga, gx, gy), kld.BIG)

    def cond(carry):
        _, changed = carry
        return changed

    def body(carry):
        labels, _ = carry
        new = jnp.where(occ3, _box_min(labels), kld.BIG)
        return new, jnp.any(new != labels)

    labels, _ = jax.lax.while_loop(cond, body, (init, jnp.array(True)))
    return labels.reshape(-1)


# Static capacity of the sorted path's unique-bin compaction. Tracking
# clouds occupy hundreds of bins; clouds with more unique bins (deep global
# localization) take the grid-gather branch of the lax.cond instead.
MAX_UNIQUE_BINS = 8192


def _label_grid_machinery(occ, shape):
    """Dilate occupancy into component labels and dense root ranks —
    O(cells) vector work shared by every ranks path."""
    labels_grid = _cluster_grid(occ, shape)
    n_cells = labels_grid.shape[0]
    cell_idx = jnp.arange(n_cells, dtype=jnp.int32)
    is_root = occ & (labels_grid == cell_idx)
    rank_grid = jnp.cumsum(is_root.astype(jnp.int32)) - 1  # rank at roots
    cluster_count = jnp.sum(is_root).astype(jnp.int32)
    return labels_grid, rank_grid, cluster_count


def _ranks_grid_path(flat, active, shape):
    """Per-particle cluster ranks via one M-sized occupancy scatter plus
    two M-sized dependent gathers (the round-2 formulation).
    Used by the fleet path (PFParams.stats_max_clusters) and as the
    spread-cloud fallback when unique bins exceed MAX_UNIQUE_BINS."""
    occ = kld.occupancy_grid(flat, active, shape)
    labels_grid, rank_grid, cluster_count = _label_grid_machinery(occ, shape)
    n_cells = labels_grid.shape[0]
    lbl_p = labels_grid[flat]
    rank_p = rank_grid[jnp.clip(lbl_p, 0, n_cells - 1)]
    return rank_p, cluster_count


# Compact CC grid for tight clouds: when the unique bins' (x, y) spans fit,
# the roll-dilation/labeling runs on a 32 x 32 x 40 grid (160 KB/roll)
# instead of the full hist grid (10 MB/roll at the 256 x 256 x 40 default).
# Root ranks are IDENTICAL either way: the recode is a monotone per-axis
# shift, so lexicographic root order (and hence the cumsum rank) and the
# min-label components are preserved.
SMALL_GRID = (32, 32, 40)


def _ranks_from_unique(uk_raw, valid_u, shape):
    """(rank_u (u,), cluster_count) for <= MAX_UNIQUE_BINS compacted unique
    bins (big-grid flat encodings, ascending; valid_u masks real entries —
    invalid slots get garbage ranks the caller must mask). Scatters only the
    valid bins into the occupancy grid (compact SMALL_GRID when the valid
    bins' spans fit, the full hist grid otherwise) and gathers label->rank
    for those only — O(u) work, never O(M)."""
    gx, gy, ga = shape
    n_cells = gx * gy * ga
    # decode the (a, x, y) grid coordinates from the big-grid flat encoding
    a_u = uk_raw // (gx * gy)
    rem = uk_raw - a_u * (gx * gy)
    x_u = rem // gy
    y_u = rem - x_u * gy

    def axis_iv(v):
        return (jnp.min(jnp.where(valid_u, v, kld.BIG)),
                jnp.max(jnp.where(valid_u, v, -kld.BIG)))

    x_lo, x_hi = axis_iv(x_u)
    y_lo, y_hi = axis_iv(y_u)
    a_lo, a_hi = axis_iv(a_u)
    gsx, gsy, gsa = SMALL_GRID
    fits_small = (
        (x_hi - x_lo <= gsx - 3) & (y_hi - y_lo <= gsy - 3)
        & (a_hi - a_lo <= gsa - 3)
    )

    def small(_):
        xs = jnp.clip(x_u - x_lo + 1, 0, gsx - 2)
        ys = jnp.clip(y_u - y_lo + 1, 0, gsy - 2)
        as_ = jnp.clip(a_u - a_lo + 1, 0, gsa - 2)
        flat_s = (as_ * gsx + xs) * gsy + ys
        n_s = gsx * gsy * gsa
        occ = jnp.zeros((n_s,), bool).at[
            jnp.where(valid_u, flat_s, n_s)
        ].set(True, mode="drop")
        labels_grid, rank_grid, cluster_count = _label_grid_machinery(
            occ, SMALL_GRID)
        lab_u = labels_grid[jnp.clip(flat_s, 0, n_s - 1)]
        rank_u = rank_grid[jnp.clip(lab_u, 0, n_s - 1)]
        return rank_u, cluster_count

    def big(_):
        occ = jnp.zeros((n_cells,), bool).at[
            jnp.where(valid_u, uk_raw, n_cells)
        ].set(True, mode="drop")
        labels_grid, rank_grid, cluster_count = _label_grid_machinery(
            occ, shape)
        uk = jnp.clip(uk_raw, 0, n_cells - 1)
        lab_u = labels_grid[uk]
        rank_u = rank_grid[jnp.clip(lab_u, 0, n_cells - 1)]
        return rank_u, cluster_count

    return jax.lax.cond(fits_small, small, big, operand=None)


def _ranks_sorted_path(sb, shape):
    """Per-particle cluster ranks from the pre-sorted bin structure
    (round 3): partition the <= MAX_UNIQUE_BINS unique bins to the front,
    rank them on the occupancy grid (_ranks_from_unique), broadcast back to
    particles through the tiny table (one-hot contraction), restore draw
    order with a second sort. All M-sized steps are sorts/scans/matmuls —
    no M-sized scatter or gather."""
    u = MAX_UNIQUE_BINS
    ks, idx_s, act_s, segstart = sb
    segid = jnp.cumsum(segstart.astype(jnp.int32)) - 1  # -1 before 1st seg
    # partition: unique keys to the front, in first-seen (ascending) order
    pk = jnp.where(segstart, 0, 1).astype(jnp.int32)
    _, ks_c = jax.lax.sort((pk, ks), num_keys=1, is_stable=True)
    uk_raw = ks_c[:u]
    valid_u = uk_raw < kld.BIG
    rank_u, cluster_count = _ranks_from_unique(uk_raw, valid_u, shape)
    # per-particle (sorted order) rank via the tiny table, then restore
    from badger_amcl.ops import mxu_gather

    rank_s = mxu_gather.broadcast_small(
        rank_u.astype(jnp.float32), jnp.clip(segid, 0, u - 1)
    ).astype(jnp.int32)
    _, rank_d = jax.lax.sort((idx_s, rank_s), num_keys=1, is_stable=True)
    return rank_d, cluster_count


def compute_cluster_stats(poses, weights, active, params,
                          precomputed_ranks=None) -> ClusterStats:
    """Full computeClusterStatsForSet (particle_filter.cpp:505-636):
    cluster the histogram, then accumulate per-cluster and whole-set
    weighted statistics with circular yaw means.

    Segment ids in the returned arrays are dense cluster ranks (< M).
    precomputed_ranks: optional (rank_p (M,), cluster_count) computed by a
    caller that already binned/sorted these poses (the fused multinomial
    resample, pf.filter._resample_multinomial_fused) — skips the rank
    machinery here."""
    m = poses.shape[0]
    shape = params.hist_shape

    if precomputed_ranks is not None:
        rank_p, cluster_count = precomputed_ranks
    elif params.stats_max_clusters:
        # fleet path (vmapped): sorts lower poorly under vmap, and a
        # lax.cond would run BOTH branches — stay on the grid gathers
        _, flat = kld.grid_cells(kld.bin_keys(poses), active, shape)
        rank_p, cluster_count = _ranks_grid_path(flat, active, shape)
    else:
        _, flat = kld.grid_cells(kld.bin_keys(poses), active, shape)
        sb = kld.sort_by_bin(flat, active)
        u_count = jnp.sum(sb[3]).astype(jnp.int32)
        rank_p, cluster_count = jax.lax.cond(
            u_count <= MAX_UNIQUE_BINS,
            lambda _: _ranks_sorted_path(sb, shape),
            lambda _: _ranks_grid_path(flat, active, shape),
            operand=None,
        )

    pc = jnp.where(active, rank_p, m - 1).astype(jnp.int32)
    pc = jnp.clip(pc, 0, m - 1)

    w = jnp.where(active, weights, 0.0)
    x, y, th = poses[:, 0], poses[:, 1], poses[:, 2]
    c, s = jnp.cos(th), jnp.sin(th)

    # All nine per-cluster accumulators at once. Almost always the live
    # cluster count is tiny (converged cloud: 1-5), so one (9, M) @ (M, K)
    # one-hot contraction replaces nine scatter-adds; clouds with more than
    # K clusters (deep global localization) fall back to segment_sum.
    vals = jnp.stack(
        [w, jnp.where(active, 1.0, 0.0), w * x, w * y, w * c, w * s,
         w * x * x, w * x * y, w * y * y]
    ).astype(jnp.float32)
    cap = params.stats_max_clusters
    k_fast = min(cap if cap else MAX_FAST_CLUSTERS, m)

    def _finalize(sums, width):
        """Per-cluster means/covs + whole-set stats from the (9, width)
        segment sums, all at `width` (the fast arm runs this at K=128, not
        M: the live entries never exceed the cluster cap). The set
        stats are the sums over clusters of the same accumulators
        (reassociation only — every active particle lands in exactly one
        cluster segment here: fast arm runs only when cluster_count <=
        k_fast, so no id is dropped)."""
        cw, cnt_f, mx, my, mc, ms, cxx, cxy, cyy = sums
        cnt = jnp.round(cnt_f).astype(jnp.int32)
        root = jnp.arange(width) < cluster_count
        safe_w = jnp.where(cw > 0, cw, 1.0)
        mean_x = mx / safe_w
        mean_y = my / safe_w
        mean_a = jnp.arctan2(ms, mc)
        cluster_means = jnp.stack([mean_x, mean_y, mean_a], axis=1)
        # covariance (normalizeCluster, particle_filter.cpp:555-568); yaw
        # variance uses the *raw* weighted cos/sin sums, as the reference
        cov = jnp.zeros((width, 3, 3), jnp.float32)
        cov = cov.at[:, 0, 0].set(cxx / safe_w - mean_x * mean_x)
        cov = cov.at[:, 0, 1].set(cxy / safe_w - mean_x * mean_y)
        cov = cov.at[:, 1, 0].set(cxy / safe_w - mean_x * mean_y)
        cov = cov.at[:, 1, 1].set(cyy / safe_w - mean_y * mean_y)
        r = jnp.sqrt(mc * mc + ms * ms)
        cov = cov.at[:, 2, 2].set(-2.0 * jnp.log(jnp.maximum(r, 1e-30)))

        # whole-set stats (computeSetStats, particle_filter.cpp:620-636)
        rootf = root.astype(jnp.float32)
        tw = jnp.sum(cw * rootf)
        safe_tw = jnp.where(tw > 0, tw, 1.0)
        smx = jnp.sum(mx * rootf) / safe_tw
        smy = jnp.sum(my * rootf) / safe_tw
        smc, sms = jnp.sum(mc * rootf), jnp.sum(ms * rootf)
        set_mean = jnp.stack([smx, smy, jnp.arctan2(sms, smc)])
        set_cov = jnp.zeros((3, 3), jnp.float32)
        set_cov = set_cov.at[0, 0].set(
            jnp.sum(cxx * rootf) / safe_tw - smx * smx)
        set_cov = set_cov.at[0, 1].set(
            jnp.sum(cxy * rootf) / safe_tw - smx * smy)
        set_cov = set_cov.at[1, 0].set(set_cov[0, 1])
        set_cov = set_cov.at[1, 1].set(
            jnp.sum(cyy * rootf) / safe_tw - smy * smy)
        # NOTE: raw weighted cos/sin sums (computeSetStats,
        # particle_filter.cpp:635)
        sr = jnp.sqrt(smc * smc + sms * sms)
        set_cov = set_cov.at[2, 2].set(-2.0 * jnp.log(jnp.maximum(sr, 1e-30)))

        def padm(a):
            if width == m:
                return a
            return jnp.concatenate(
                [a, jnp.zeros((m - width,) + a.shape[1:], a.dtype)]
            )

        return ClusterStats(
            cluster_count=cluster_count,
            cluster_valid=padm(root),
            cluster_weights=padm(jnp.where(root, cw, 0.0)),
            cluster_counts=padm(jnp.where(root, cnt, 0)),
            cluster_means=padm(jnp.where(root[:, None], cluster_means, 0.0)),
            cluster_covs=padm(jnp.where(root[:, None, None], cov, 0.0)),
            mean=set_mean.astype(jnp.float32),
            cov=set_cov,
            particle_cluster=pc,
        )

    def seg_fast(_):
        from badger_amcl.ops import mxu_gather

        sums_k = mxu_gather.segment_sums_small(vals, pc, k_fast)
        return _finalize(sums_k, k_fast)

    def seg_slow(_):
        sums = jnp.stack(
            [jax.ops.segment_sum(v, pc, num_segments=m) for v in vals]
        )
        return _finalize(sums, m)

    if cap:
        # fleet configuration: one-hot only, clusters past the cap drop out of
        # the statistics (see PFParams.stats_max_clusters). Their particles
        # ARE dropped from the set sums here too — acceptable under the
        # cap's documented approximation; the single-robot path never caps.
        return seg_fast(None)
    return jax.lax.cond(
        cluster_count <= k_fast, seg_fast, seg_slow, operand=None
    )
