"""2D occupancy map as device-resident textures.

Device-resident re-design of the reference's `OccupancyMap`
(src/amcl/map/occupancy_map.cpp, include/amcl/map/occupancy_map.h): the cell
state grid and the distance-to-object LUT live as dense `(H, W)` device
arrays gathered by the sensor kernels, and all world<->map conversions are
pure vectorized functions.

Conventions preserved exactly:
- cell states FREE=-1, UNKNOWN=0, OCCUPIED=1 (occupancy_map.h:36-41)
- *center-origin* world<->map conversion (occupancy_map.cpp:75-98):
    world = origin + (ij - size/2) * res
    ij    = floor((world - origin)/res + 0.5) + size//2
- distance LUT capped at max_distance_to_object via the cell_radius rule
  (occupancy_map.cpp:224-242)
- grid indexing is (i=x, j=y), row-major with index i + j*size_x
  (occupancy_map.cpp:107-110); our textures are stored as arrays of shape
  (size_y, size_x) indexed [j, i], which is the same memory layout.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from badger_amcl.maps.edt import capped_distance_field


class CellState(enum.IntEnum):
    """MapCellState (reference occupancy_map.h:36-41)."""

    FREE = -1
    UNKNOWN = 0
    OCCUPIED = 1


def grid_from_probabilities(data: np.ndarray) -> np.ndarray:
    """Convert ROS OccupancyGrid-style data (0..100 / -1) to CellState int8.

    0 -> FREE, 100 -> OCCUPIED, anything else -> UNKNOWN
    (reference node_2d.cpp:286-291).
    """
    data = np.asarray(data)
    out = np.zeros(data.shape, dtype=np.int8)  # UNKNOWN
    out[data == 0] = int(CellState.FREE)
    out[data == 100] = int(CellState.OCCUPIED)
    return out


@dataclasses.dataclass(frozen=True)
class OccupancyMap2D:
    """Immutable 2D map bundle. All jnp fields are device arrays.

    cells:     int8 (H, W) CellState values, indexed [j, i]
    distances: float32 (H, W) distance-to-nearest-obstacle in meters, capped,
               or None until `with_distance_field` is called
    """

    resolution: float
    size_x: int
    size_y: int
    origin_x: float
    origin_y: float
    cells: jnp.ndarray
    distances: Optional[jnp.ndarray] = None
    max_distance_to_object: float = 0.0
    # optional pre-baked recalcWeight factor texture (cell state + distance
    # fused; sensors.planar.bake_factor_texture), tagged by the params it
    # embeds (non_free_space_factor, non_free_space_radius). Saves the
    # per-call full-map elementwise rebuild in sensors.planar.map_factors.
    factor_tex: Optional[jnp.ndarray] = None
    factor_key: Optional[tuple] = None

    # --- construction -----------------------------------------------------

    @staticmethod
    def from_cells(
        cells: np.ndarray,
        resolution: float,
        origin_x: float = 0.0,
        origin_y: float = 0.0,
    ) -> "OccupancyMap2D":
        """cells: int8 (H=size_y, W=size_x) CellState grid, indexed [j, i]."""
        cells = np.asarray(cells, dtype=np.int8)
        h, w = cells.shape
        return OccupancyMap2D(
            resolution=float(resolution),
            size_x=w,
            size_y=h,
            origin_x=float(origin_x),
            origin_y=float(origin_y),
            cells=jnp.asarray(cells),
        )

    @staticmethod
    def from_occupancy_grid_msg(
        width: int,
        height: int,
        resolution: float,
        origin_position_x: float,
        origin_position_y: float,
        data: np.ndarray,
        map_scale_up_factor: int = 1,
    ) -> "OccupancyMap2D":
        """Build from a ROS-style OccupancyGrid message, reproducing the
        reference's supersampling conversion (node_2d.cpp:265-295):

        - effective resolution = msg.resolution / scale
        - size = msg.size * scale
        - origin = msg.origin + (size/2) * resolution   (center-origin)
        - each supersampled cell copies its parent's state
        """
        s = int(map_scale_up_factor)
        res = float(resolution) / s
        w, h = int(width) * s, int(height) * s
        ox = float(origin_position_x) + (w // 2) * res
        oy = float(origin_position_y) + (h // 2) * res
        base = grid_from_probabilities(np.asarray(data).reshape(int(height), int(width)))
        cells = np.repeat(np.repeat(base, s, axis=0), s, axis=1)
        return OccupancyMap2D(
            resolution=res,
            size_x=w,
            size_y=h,
            origin_x=ox,
            origin_y=oy,
            cells=jnp.asarray(cells),
        )

    def with_distance_field(self, max_distance_to_object: float) -> "OccupancyMap2D":
        """Build the distance-to-object LUT (reference `updateDistancesLUT`,
        occupancy_map.cpp:138-160). Host-side exact EDT, device-resident
        result."""
        occ = np.asarray(self.cells) == int(CellState.OCCUPIED)
        lut = capped_distance_field(occ, self.resolution, float(max_distance_to_object))
        return dataclasses.replace(
            self,
            distances=jnp.asarray(lut),
            max_distance_to_object=float(max_distance_to_object),
        )

    @property
    def distances_lut_created(self) -> bool:
        """Gate used by the node layer to drop scans until the EDT exists
        (reference map.h:53, node_2d.cpp:406)."""
        return self.distances is not None

    # --- conversions (pure, batched) --------------------------------------

    def world_to_map(self, xy):
        """(..., 2) world meters -> (..., 2) integer cell indices (i, j).

        Matches occupancy_map.cpp:90-98 exactly (floor(x/res + 0.5) + size/2).
        """
        xy = jnp.asarray(xy)
        origin = jnp.array([self.origin_x, self.origin_y], dtype=xy.dtype)
        half = jnp.array([self.size_x // 2, self.size_y // 2], dtype=jnp.int32)
        ij = jnp.floor((xy - origin) / self.resolution + 0.5).astype(jnp.int32) + half
        return ij

    def map_to_world(self, ij):
        """(..., 2) integer cell indices -> (..., 2) world meters (cell centers).

        Matches occupancy_map.cpp:75-88."""
        ij = jnp.asarray(ij)
        origin = jnp.array([self.origin_x, self.origin_y], dtype=jnp.float32)
        half = jnp.array([self.size_x // 2, self.size_y // 2], dtype=ij.dtype)
        return origin + (ij - half).astype(jnp.float32) * self.resolution

    def is_valid(self, ij):
        """(..., 2) -> bool (...). Bounds check (occupancy_map.cpp:100-105)."""
        i = ij[..., 0]
        j = ij[..., 1]
        return (i >= 0) & (i < self.size_x) & (j >= 0) & (j < self.size_y)

    # --- gathers ------------------------------------------------------------

    def _flat_index(self, ij):
        """Clipped linear index into the (H, W) texture for safe gathers."""
        i = jnp.clip(ij[..., 0], 0, self.size_x - 1)
        j = jnp.clip(ij[..., 1], 0, self.size_y - 1)
        return j * self.size_x + i

    def cell_state_at(self, ij):
        """Gather CellState at (..., 2) indices. Out-of-bounds reads are the
        caller's concern (pair with `is_valid`), clipped here for safety."""
        flat = self._flat_index(ij)
        return jnp.take(self.cells.reshape(-1), flat)

    def distance_at(self, ij):
        """Gather distance-to-object at (..., 2); out-of-bounds -> max distance
        (reference getDistanceToObject, occupancy_map.cpp:64-73)."""
        flat = self._flat_index(ij)
        d = jnp.take(self.distances.reshape(-1), flat)
        return jnp.where(self.is_valid(ij), d, self.max_distance_to_object)

    # --- derived host-side products ----------------------------------------

    def free_space_indices(self, non_free_space_radius: float = 0.0) -> np.ndarray:
        """(F, 2) int32 array of FREE cells farther than `radius` from any
        obstacle (reference updateFreeSpaceIndices, node_2d.cpp:318-338).
        Requires the distance field."""
        cells = np.asarray(self.cells)
        free = cells == int(CellState.FREE)
        if self.distances is not None:
            far = np.asarray(self.distances) > non_free_space_radius
            free = free & far
        j, i = np.nonzero(free)
        return np.stack([i, j], axis=1).astype(np.int32)


# Register as a pytree so jitted kernels take the map as an argument (textures
# as leaves, geometry as hashable aux data) instead of baking the textures
# into the compiled HLO as constants.
def _occ_flatten(m: OccupancyMap2D):
    leaves = (m.cells, m.distances, m.factor_tex)
    aux = (m.resolution, m.size_x, m.size_y, m.origin_x, m.origin_y,
           m.max_distance_to_object, m.distances is None,
           m.factor_tex is None, m.factor_key)
    return leaves, aux


def _occ_unflatten(aux, leaves):
    res, sx, sy, ox, oy, maxd, no_dist, no_ftex, f_key = aux
    cells, distances, factor_tex = leaves
    return OccupancyMap2D(
        resolution=res, size_x=sx, size_y=sy, origin_x=ox, origin_y=oy,
        cells=cells, distances=None if no_dist else distances,
        max_distance_to_object=maxd,
        factor_tex=None if no_ftex else factor_tex,
        factor_key=f_key,
    )


jax.tree_util.register_pytree_node(OccupancyMap2D, _occ_flatten, _occ_unflatten)
