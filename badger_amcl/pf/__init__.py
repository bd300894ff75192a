from badger_amcl.pf.types import MCLState, PFParams  # noqa: F401
from badger_amcl.pf import filter as pf_filter  # noqa: F401
from badger_amcl.pf.filter import (  # noqa: F401
    init_with_gaussian,
    init_with_poses,
    sensor_update,
    resample,
)
