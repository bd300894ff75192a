"""3D voxel distance field baked from an octree.

Device-resident re-design of the reference's `OctoMap`
(src/amcl/map/octomap.cpp, include/amcl/map/octomap.h): occupied octree
leaves are rasterized into a cropped voxel volume, the exact Euclidean
distance field is computed host-side, quantized to uint8 with the reference's
exact contract, and the result lives on device as a dense (nx, ny, nz) uint8
texture gathered by the point-cloud measurement model.

Contracts preserved:
- zero-origin world<->map conversion: world = cell*res, cell = floor(w/res+0.5)
  (octomap.cpp:83-109)
- cropped cell bounds from the octree metric min/max (octomap.cpp:53-74),
  optionally intersected with 2D-map bounds padded by max_distance_to_object
  (`setMapBounds`, octomap.cpp:128-150)
- uint8 quantization: ratio = floor(min(d, max_d)/max_d * 255);
  distance read back as ratio * (max_d/255) (octomap.cpp:315-350)
- out-of-bounds lookups return max_distance_to_object (octomap.cpp:336-341)

The reference stores the volume column-compressed (lazily allocated z-columns,
octomap.h:97-98) to save host RAM; on the device a dense texture is both
smaller (uint8) and what batched gathers need, so density is the design point
here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from badger_amcl.maps.edt import edt_3d
from badger_amcl.utils import native


@dataclasses.dataclass(frozen=True)
class OctoMap3D:
    """Immutable 3D map bundle.

    distances_u8: uint8 (nx, ny, nz) quantized distance ratios (device array),
                  None until `with_distance_field` runs.
    min_cells/max_cells: inclusive cropped voxel bounds in map cells.
    """

    resolution: float
    max_distance_to_object: float
    min_cells: Tuple[int, int, int]
    max_cells: Tuple[int, int, int]
    occupied_cells: np.ndarray  # (K, 3) int32 host array (pre-crop)
    distances_u8: Optional[jnp.ndarray] = None

    # --- construction -------------------------------------------------------

    @staticmethod
    def from_occupied_points(
        points: np.ndarray,
        resolution: float,
        max_distance_to_object: float,
        metric_min: Optional[Sequence[float]] = None,
        metric_max: Optional[Sequence[float]] = None,
    ) -> "OctoMap3D":
        """points: (K, 3) world coordinates of occupied voxel centers.

        metric_min/max default to the point extents (the reference uses the
        octree's metric bounds, octomap.cpp:58-70).
        """
        pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
        if metric_min is None:
            metric_min = pts.min(axis=0) if len(pts) else np.zeros(3)
        if metric_max is None:
            metric_max = pts.max(axis=0) if len(pts) else np.zeros(3)
        min_cells = tuple(int(np.floor(v / resolution + 0.5)) for v in metric_min)
        max_cells = tuple(int(np.floor(v / resolution + 0.5)) for v in metric_max)
        cells = np.floor(pts / resolution + 0.5).astype(np.int32)
        return OctoMap3D(
            resolution=float(resolution),
            max_distance_to_object=float(max_distance_to_object),
            min_cells=min_cells,
            max_cells=max_cells,
            occupied_cells=cells,
        )

    @staticmethod
    def from_binary_octree(tree, max_distance_to_object: float) -> "OctoMap3D":
        """Build from a `badger_amcl.maps.octree_io.BinaryOcTree`."""
        centers = tree.occupied_centers()
        return OctoMap3D.from_occupied_points(
            centers, tree.resolution, max_distance_to_object
        )

    def set_map_bounds(
        self, map_min: Sequence[float], map_max: Sequence[float]
    ) -> "OctoMap3D":
        """Intersect the cropped bounds with 2D-map bounds padded by
        max_distance_to_object, then rebake (reference setMapBounds,
        octomap.cpp:128-150 — the pad keeps objects at map edges
        represented). map_min/map_max are 2D (x, y) world coords."""
        lo = [v - self.max_distance_to_object for v in map_min]
        hi = [v + self.max_distance_to_object for v in map_max]
        lo_cells = [int(np.floor(v / self.resolution + 0.5)) for v in lo]
        hi_cells = [int(np.floor(v / self.resolution + 0.5)) for v in hi]
        new_min = list(self.min_cells)
        new_max = list(self.max_cells)
        for a in range(len(lo_cells)):
            new_min[a] = max(new_min[a], lo_cells[a])
            new_max[a] = min(new_max[a], hi_cells[a])
        cropped = dataclasses.replace(
            self, min_cells=tuple(new_min), max_cells=tuple(new_max)
        )
        return cropped.with_distance_field()

    def with_distance_field(self) -> "OctoMap3D":
        """Bake the quantized voxel EDT (reference updateDistancesLUT,
        octomap.cpp:174-207). Exact host-side EDT replaces the reference's
        6-neighbor BFS wavefront; the quantization contract is identical."""
        nx = self.max_cells[0] - self.min_cells[0] + 1
        ny = self.max_cells[1] - self.min_cells[1] + 1
        nz = self.max_cells[2] - self.min_cells[2] + 1
        if nx <= 0 or ny <= 0 or nz <= 0:
            raise ValueError("empty cropped volume")
        occ = np.zeros((nx, ny, nz), dtype=bool)
        c = self.occupied_cells - np.array(self.min_cells, dtype=np.int32)
        inb = (
            (c[:, 0] >= 0)
            & (c[:, 0] < nx)
            & (c[:, 1] >= 0)
            & (c[:, 1] < ny)
            & (c[:, 2] >= 0)
            & (c[:, 2] < nz)
        )  # out-of-crop occupied leaves are skipped (octomap.cpp:232)
        c = c[inb]
        occ[c[:, 0], c[:, 1], c[:, 2]] = True

        d_cells = native.edt_cells(occ)
        if d_cells is None:
            d_cells = edt_3d(occ)
        d_m = np.minimum(d_cells * self.resolution, self.max_distance_to_object)
        ratios = np.floor(d_m / self.max_distance_to_object * 255.0).astype(np.uint8)
        return dataclasses.replace(self, distances_u8=jnp.asarray(ratios))

    @property
    def distances_lut_created(self) -> bool:
        return self.distances_u8 is not None

    @property
    def max_distance_ratio(self) -> float:
        """Quantization step: max_distance_to_object / 255 (octomap.cpp:57)."""
        return self.max_distance_to_object / 255.0

    # --- conversions (pure, batched) -----------------------------------------

    def world_to_map(self, xyz):
        """(..., 3) world meters -> (..., 3) voxel cells (octomap.cpp:98-109)."""
        xyz = jnp.asarray(xyz)
        return jnp.floor(xyz / self.resolution + 0.5).astype(jnp.int32)

    def map_to_world(self, cells):
        """(..., 3) voxel cells -> (..., 3) world meters (octomap.cpp:83-95)."""
        return jnp.asarray(cells).astype(jnp.float32) * self.resolution

    def is_pose_valid(self, i, j):
        """2D in-bounds check used by recalcWeight (octomap.cpp:112-116)."""
        return (
            (i >= self.min_cells[0])
            & (i <= self.max_cells[0])
            & (j >= self.min_cells[1])
            & (j <= self.max_cells[1])
        )

    def is_voxel_valid(self, ijk):
        i, j, k = ijk[..., 0], ijk[..., 1], ijk[..., 2]
        return (
            self.is_pose_valid(i, j)
            & (k >= self.min_cells[2])
            & (k <= self.max_cells[2])
        )

    def distance_at(self, ijk):
        """Gather distance-to-object (meters) at (..., 3) voxel cells;
        out-of-bounds -> max_distance_to_object (octomap.cpp:336-350)."""
        ijk = jnp.asarray(ijk)
        mins = jnp.array(self.min_cells, dtype=ijk.dtype)
        maxs = jnp.array(self.max_cells, dtype=ijk.dtype)
        shifted = jnp.clip(ijk - mins, 0, maxs - mins)
        nx, ny, nz = self.distances_u8.shape
        flat = (shifted[..., 0] * ny + shifted[..., 1]) * nz + shifted[..., 2]
        ratio = jnp.take(self.distances_u8.reshape(-1), flat)
        d = ratio.astype(jnp.float32) * self.max_distance_ratio
        return jnp.where(self.is_voxel_valid(ijk), d, self.max_distance_to_object)

    def distances_lut_cloud(self, max_count: int = 1_000_000) -> np.ndarray:
        """Debug dump of the LUT as an intensity point cloud — (K, 4) rows of
        (x, y, z, distance) for voxels with distance < max, capped at
        max_count (publishDistancesLUT, octomap.cpp:357-395)."""
        if self.distances_u8 is None:
            return np.zeros((0, 4))
        ratios = np.asarray(self.distances_u8)
        sel = ratios < 255
        idx = np.argwhere(sel)
        if len(idx) > max_count:
            idx = idx[:max_count]
        cells = idx + np.array(self.min_cells)
        d = ratios[idx[:, 0], idx[:, 1], idx[:, 2]] * self.max_distance_ratio
        world = cells.astype(np.float64) * self.resolution
        return np.concatenate([world, d[:, None]], axis=1)

    # --- derived host-side products -------------------------------------------

    def free_space_indices(self) -> np.ndarray:
        """(F, 2) int32 (i, j) cells spanning the cropped footprint.

        The reference uses *all* in-bounds (i, j) pairs — its TODO at
        node_3d.cpp:306-318 — exclusive of the max cell. Reproduced exactly."""
        i = np.arange(self.min_cells[0], self.max_cells[0])
        j = np.arange(self.min_cells[1], self.max_cells[1])
        gi, gj = np.meshgrid(i, j, indexing="ij")
        return np.stack([gi.ravel(), gj.ravel()], axis=1).astype(np.int32)


# pytree registration: uint8 texture as the leaf, geometry as aux data.
# occupied_cells stays host-side (aux, hashed by identity) — it is
# construction scaffolding, never touched inside jit.
class _HashById:
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def __hash__(self):
        return id(self.value)

    def __eq__(self, other):
        return isinstance(other, _HashById) and other.value is self.value


def _octo_flatten(m: OctoMap3D):
    leaves = (m.distances_u8,)
    aux = (m.resolution, m.max_distance_to_object, m.min_cells, m.max_cells,
           _HashById(m.occupied_cells), m.distances_u8 is None)
    return leaves, aux


def _octo_unflatten(aux, leaves):
    res, maxd, mins, maxs, occ, no_dist = aux
    (dist,) = leaves
    return OctoMap3D(
        resolution=res, max_distance_to_object=maxd, min_cells=mins,
        max_cells=maxs, occupied_cells=occ.value,
        distances_u8=None if no_dist else dist,
    )


jax.tree_util.register_pytree_node(OctoMap3D, _octo_flatten, _octo_unflatten)
