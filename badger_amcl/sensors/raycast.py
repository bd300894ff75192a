"""Vectorized Bresenham raycasting against the occupancy grid.

Reproduces `OccupancyMap::calcRange` (src/amcl/map/occupancy_map.cpp:257-364)
exactly — including its conventions: unknown and out-of-bounds cells are
treated as occupied, the returned range is the *Euclidean cell distance*
(not path length) times resolution, the start cell is tested before
stepping, and coincident endpoints return max_range.

The reference runs this per beam per particle inside nested loops (hot loop
#2b, SURVEY.md §3.1); here the whole `(N, B)` ray bundle advances in
lockstep under one `lax.while_loop` with per-ray done masking — each
iteration is one batched cell gather, so the loop runs until the longest
ray in the batch ends.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from badger_amcl.maps.occupancy_2d import CellState, OccupancyMap2D


def calc_range(
    omap: OccupancyMap2D,
    ox: jnp.ndarray,
    oy: jnp.ndarray,
    oa: jnp.ndarray,
    max_range,
) -> jnp.ndarray:
    """Batched calcRange. ox/oy/oa may have any (broadcastable) shape; returns
    ranges of the same shape (meters)."""
    ox, oy, oa = jnp.broadcast_arrays(
        jnp.asarray(ox, jnp.float32), jnp.asarray(oy, jnp.float32), jnp.asarray(oa, jnp.float32)
    )
    shape = ox.shape
    max_range = jnp.float32(max_range)

    p0 = omap.world_to_map(jnp.stack([ox, oy], axis=-1))
    p1 = omap.world_to_map(
        jnp.stack([ox + max_range * jnp.cos(oa), oy + max_range * jnp.sin(oa)], axis=-1)
    )
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]

    same = (x0 == x1) & (y0 == y1)
    steep = jnp.abs(y1 - y0) > jnp.abs(x1 - x0)
    # swap into the driving axis (occupancy_map.cpp:287-296)
    sx0 = jnp.where(steep, y0, x0)
    sy0 = jnp.where(steep, x0, y0)
    sx1 = jnp.where(steep, y1, x1)
    sy1 = jnp.where(steep, x1, y1)

    deltax = jnp.abs(sx1 - sx0)
    deltay = jnp.abs(sy1 - sy0)
    xstep = jnp.where(sx0 < sx1, 1, -1)
    ystep = jnp.where(sy0 < sy1, 1, -1)

    cells = omap.cells.reshape(-1)
    size_x, size_y = omap.size_x, omap.size_y

    def blocked(x, y):
        """Cell test in swapped coords: real (i, j) = (y, x) if steep else (x, y)."""
        i = jnp.where(steep, y, x)
        j = jnp.where(steep, x, y)
        valid = (i >= 0) & (i < size_x) & (j >= 0) & (j < size_y)
        flat = jnp.clip(j, 0, size_y - 1) * size_x + jnp.clip(i, 0, size_x - 1)
        state = jnp.take(cells, flat)
        return (~valid) | (state != jnp.int8(CellState.FREE))

    def dist(x, y):
        dx = (x - sx0).astype(jnp.float32)
        dy = (y - sy0).astype(jnp.float32)
        return jnp.sqrt(dx * dx + dy * dy) * omap.resolution

    # start-cell test (occupancy_map.cpp:315-332)
    hit0 = blocked(sx0, sy0) & ~same
    result = jnp.where(same, max_range, jnp.where(hit0, dist(sx0, sy0), max_range))
    done = same | hit0

    def cond(carry):
        _, _, _, done, _ = carry
        return jnp.any(~done)

    def body(carry):
        x, y, err, done, result = carry
        past_end = x == sx1 + xstep  # loop guard `while (x != x1 + xstep)`
        done = done | past_end
        nx = x + xstep
        nerr = err + deltay
        bump = 2 * nerr >= deltax
        ny = jnp.where(bump, y + ystep, y)
        nerr = jnp.where(bump, nerr - deltax, nerr)
        hit = blocked(nx, ny) & ~done
        result = jnp.where(hit, dist(nx, ny), result)
        done = done | hit
        # only advance live rays so their (x, y) stays meaningful
        x = jnp.where(done, x, nx)
        y = jnp.where(done, y, ny)
        err = jnp.where(done, err, nerr)
        return x, y, err, done, result

    err0 = jnp.zeros(shape, jnp.int32)
    _, _, _, _, result = jax.lax.while_loop(
        cond, body, (sx0, sy0, err0, done, result)
    )
    return result
