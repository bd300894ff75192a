from badger_amcl.maps.occupancy_2d import (  # noqa: F401
    CellState,
    OccupancyMap2D,
    grid_from_probabilities,
)
from badger_amcl.maps.edt import edt_2d, edt_3d, capped_distance_field  # noqa: F401
from badger_amcl.maps.octomap_3d import OctoMap3D  # noqa: F401
