"""KLD-sampling support: dense pose-histogram binning and the Fox population
bound.

The reference tracks occupied histogram bins with an unbalanced kd-tree
(src/amcl/pf/pf_kdtree.cpp) whose leaf count feeds `resampleLimit`
(particle_filter.cpp:475-502). Pointer-chasing trees don't vectorize. Two
formulations replace it: a *dense 3D grid* over bin space
(bins: floor(pose / [0.5 m, 0.5 m, 10 deg]), pf_kdtree.cpp:33-56), positioned
relative to the particle cloud's own minimum bin:

- occupied-bin count (== kd-tree leaf count): scatter ones, sum
- first-occurrence-in-draw-order flags (the mid-stream KLD stop,
  particle_filter.cpp:416): scatter-min of the draw index, one gather back
- connected-component clustering: separable 26-neighborhood min-dilation
  over the grid (see cluster.py)

Everything is scatter + elementwise + roll — no sort, no searchsorted.
The single-robot path uses the sorted-key twins of these functions
(`*_sorted`); the fleet path keeps the grid (see PFParams.stats_max_clusters).

Grid budget (PFParams.hist_x/y/a, default 256 x 256 x 40): x/y spreads up to
127 m at 0.5 m bins and the full 2 pi of yaw bins. A more spread-out cloud
clamps into the border bins — degrading the bin count conservatively (fewer
bins -> smaller KLD population target), never crashing. Like the reference's
kd-tree, yaw bins do NOT wrap at +-pi (pf_kdtree.cpp treats the yaw key as a
plain integer), and particle yaw is never re-normalized.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

# Fixed histogram cell sizes (pf_kdtree.cpp:33-40)
CELL_X = 0.5
CELL_Y = 0.5
CELL_A = 10.0 * math.pi / 180.0

BIG = jnp.int32(2**30)


def bin_keys(poses: jnp.ndarray) -> jnp.ndarray:
    """(N, 3) poses -> (N, 3) int32 histogram keys (pf_kdtree.cpp:49-56)."""
    cell = jnp.array([CELL_X, CELL_Y, CELL_A], dtype=poses.dtype)
    return jnp.floor(poses / cell).astype(jnp.int32)


def grid_cells(keys3: jnp.ndarray, active: jnp.ndarray, shape):
    """Map bin keys to dense-grid cells relative to the active minimum.

    Returns (cells (N, 3) int32 clamped to [1, size-2] — the 1-cell border
    stays empty so roll-based dilation cannot wrap labels — and flat (N,)
    flattened cell indices; inactive entries flattened to cell 0 with the
    caller expected to mask them)."""
    gx, gy, ga = shape
    masked = jnp.where(active[:, None], keys3, BIG)
    mins = jnp.min(masked, axis=0)
    mins = jnp.where(mins == BIG, 0, mins)
    sizes = jnp.array([gx - 2, gy - 2, ga - 2], jnp.int32)
    rel = jnp.clip(keys3 - mins[None, :], 0, sizes - 1) + 1
    # (a, x, y) packing: y is the fastest-varying axis, so the rolls in
    # cluster.py move contiguous rows
    flat = (rel[:, 2] * gx + rel[:, 0]) * gy + rel[:, 1]
    return rel, jnp.where(active, flat, 0)


def occupancy_grid(flat: jnp.ndarray, active: jnp.ndarray, shape) -> jnp.ndarray:
    """bool (gx*gy*ga,) occupancy of the bin grid."""
    gx, gy, ga = shape
    n = gx * gy * ga
    occ = jnp.zeros((n,), bool)
    dst = jnp.where(active, flat, n)  # inactive -> dropped
    return occ.at[dst].set(True, mode="drop")


def leaf_count(poses: jnp.ndarray, active: jnp.ndarray, shape) -> jnp.ndarray:
    """Occupied-bin count == kd-tree leaf count (pf_kdtree.cpp:92-95)."""
    _, flat = grid_cells(bin_keys(poses), active, shape)
    return jnp.sum(occupancy_grid(flat, active, shape)).astype(jnp.int32)


def first_occurrence_flags(flat: jnp.ndarray, active: jnp.ndarray, shape):
    """Whether each entry's bin is unseen at any earlier active index —
    scatter-min of the draw index, then compare. O(N) with one scatter and
    one gather.

    Kept for the fleet path (PFParams.stats_max_clusters): the vmapped
    resample uses this grid formulation. Single-robot callers use
    `first_occurrence_flags_sorted`."""
    gx, gy, ga = shape
    n_cells = gx * gy * ga
    n = flat.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    dst = jnp.where(active, flat, n_cells)
    grid = jnp.full((n_cells,), BIG, jnp.int32).at[dst].min(idx, mode="drop")
    return (grid[flat] == idx) & active


def sort_by_bin(flat: jnp.ndarray, active: jnp.ndarray):
    """Stable-sort particle indices by bin key (inactive entries last).

    The single-robot filter core is built on multi-operand stable sorts
    instead of per-particle grid scatter/gathers. Within a bin, draw order
    is preserved (stability),
    so segment starts are exactly the reference kd-tree's first-insertion
    events.

    Returns (keys_sorted, draw_idx_sorted, active_sorted, segstart) where
    segstart marks the first (draw-earliest) entry of each occupied bin."""
    n = flat.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    skey = jnp.where(active, flat, BIG)
    ks, idx_s = jax.lax.sort((skey, idx), num_keys=1, is_stable=True)
    act_s = ks < BIG
    segstart = act_s & jnp.concatenate(
        [jnp.ones((1,), bool), ks[1:] != ks[:-1]]
    )
    return ks, idx_s, act_s, segstart


def first_occurrence_flags_sorted(flat: jnp.ndarray, active: jnp.ndarray):
    """`first_occurrence_flags` via two stable sorts (single-robot fast
    path; equivalent by stability: the first entry of each bin segment is
    the bin's minimum draw index)."""
    _, idx_s, _, segstart = sort_by_bin(flat, active)
    _, flags = jax.lax.sort(
        (idx_s, segstart.astype(jnp.int32)), num_keys=1, is_stable=True
    )
    return flags.astype(bool)


def leaf_count_sorted(poses: jnp.ndarray, active: jnp.ndarray, shape):
    """`leaf_count` via one stable sort (single-robot fast path)."""
    _, flat = grid_cells(bin_keys(poses), active, shape)
    _, _, _, segstart = sort_by_bin(flat, active)
    return jnp.sum(segstart).astype(jnp.int32)


def resample_limit(k, min_samples: int, max_samples: int, pop_err: float, pop_z: float):
    """Fox et al. KLD population bound, exactly as particle_filter.cpp:475-502.

    Vectorized over k (int array). k <= 1 -> max_samples."""
    kf = k.astype(jnp.float32)
    b = 2.0 / (9.0 * (kf - 1.0))
    c = jnp.sqrt(b) * pop_z
    x = 1.0 - b + c
    n = jnp.ceil((kf - 1.0) / (2.0 * pop_err) * x * x * x)
    n = jnp.clip(n, min_samples, max_samples).astype(jnp.int32)
    return jnp.where(k <= 1, jnp.int32(max_samples), n)
