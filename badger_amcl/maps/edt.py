"""Exact Euclidean distance transforms for map preprocessing.

The reference builds its distance-to-nearest-obstacle LUTs with a
priority-queue brushfire BFS (2D: occupancy_map.cpp:138-242; 3D:
octomap.cpp:174-312). That algorithm is inherently serial and pointer-heavy;
we instead compute the *exact* EDT with the separable Felzenszwalb-Huttenlocher
lower-envelope transform — O(n) per axis, vectorized over rows — then apply
the reference's capping contract:

    d_cells <= cell_radius (== floor(max_dist / resolution))
        -> value = d_cells * resolution
    otherwise
        -> value = max_dist

(2D: `enqueue` at occupancy_map.cpp:224-242 only writes cells whose
cached-template distance-in-cells is <= cdm_.cell_radius_, everything else
keeps the max_dist initialization from occupancy_map.cpp:181.)

This is a one-shot, load-time operation, so it runs host-side in numpy; a
native C++ implementation is provided in native/ for large maps and picked up
automatically when built (see badger_amcl.utils.native).
"""

from __future__ import annotations

import numpy as np


def _edt_1d_sq(f: np.ndarray) -> np.ndarray:
    """Felzenszwalb 1-D squared distance transform along the last axis.

    `f` is the squared-distance cost per cell (INF where no source). Operates
    on an array of shape (..., n) and returns the lower envelope values.
    Vectorized over leading axes with a python loop over n only.
    """
    shape = f.shape
    n = shape[-1]
    f2 = f.reshape(-1, n)
    m = f2.shape[0]
    d = np.empty_like(f2)
    v = np.zeros((m, n), dtype=np.int64)  # parabola locations
    z = np.full((m, n + 1), np.inf)  # boundaries
    z[:, 0] = -np.inf
    k = np.zeros(m, dtype=np.int64)  # index of rightmost parabola
    rows = np.arange(m)

    for q in range(1, n):
        fq = f2[:, q]
        while True:
            vk = v[rows, k]
            s = ((fq + q * q) - (f2[rows, vk] + vk * vk)) / (2.0 * q - 2.0 * vk)
            pop = (s <= z[rows, k]) & (k > 0)
            if not pop.any():
                break
            k[pop] -= 1
        vk = v[rows, k]
        s = ((fq + q * q) - (f2[rows, vk] + vk * vk)) / (2.0 * q - 2.0 * vk)
        k += 1
        v[rows, k] = q
        z[rows, k] = s
        z[rows, k + 1] = np.inf

    out = np.empty_like(f2)
    k = np.zeros(m, dtype=np.int64)
    for q in range(n):
        adv = z[rows, k + 1] < q
        while adv.any():
            k[adv] += 1
            adv = z[rows, k + 1] < q
        vk = v[rows, k]
        out[:, q] = (q - vk) ** 2 + f2[rows, vk]
    return out.reshape(shape)


_INF = 1e18


def edt_2d(occupied: np.ndarray) -> np.ndarray:
    """Exact Euclidean distance (in cell units) to the nearest True cell.

    occupied: bool (H, W). Returns float64 (H, W); inf where no True exists.
    """
    f = np.where(occupied, 0.0, _INF)
    f = _edt_1d_sq(f)  # along W
    f = _edt_1d_sq(np.swapaxes(f, -1, -2))  # along H
    f = np.swapaxes(f, -1, -2)
    return np.sqrt(f)


def edt_3d(occupied: np.ndarray) -> np.ndarray:
    """Exact Euclidean distance (in cell units) to the nearest True voxel.

    occupied: bool (X, Y, Z). Returns float64 (X, Y, Z).
    """
    f = np.where(occupied, 0.0, _INF)
    f = _edt_1d_sq(f)  # along Z
    f = _edt_1d_sq(np.swapaxes(f, -1, -2))  # along Y
    f = np.swapaxes(f, -1, -2)
    f = np.moveaxis(_edt_1d_sq(np.moveaxis(f, 0, -1)), -1, 0)  # along X
    return np.sqrt(f)


def capped_distance_field(
    occupied: np.ndarray, resolution: float, max_dist: float
) -> np.ndarray:
    """Distance-to-object field in meters with the reference capping contract.

    Cells farther than cell_radius = floor(max_dist/resolution) cells from any
    obstacle read exactly `max_dist` (occupancy_map.cpp:181,224-242 /
    octomap.cpp:152-170,290-312). Returns float32.
    """
    if max_dist <= 0.0:
        raise ValueError("max_dist must be > 0")
    # Prefer the native C++ EDT when it has been built (same contract).
    from badger_amcl.utils import native

    d_cells = native.edt_cells(occupied)
    if d_cells is None:
        d_cells = edt_2d(occupied) if occupied.ndim == 2 else edt_3d(occupied)
    cell_radius = int(np.floor(max_dist / resolution))
    out = np.where(
        d_cells <= cell_radius, d_cells * resolution, max_dist
    ).astype(np.float32)
    return out
