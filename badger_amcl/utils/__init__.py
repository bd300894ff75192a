from badger_amcl.utils.angles import (  # noqa: F401
    normalize_angle,
    shortest_angular_distance,
)
