from badger_amcl.sensors.odom import motion_update, OdomModel  # noqa: F401
from badger_amcl.sensors.planar import (  # noqa: F401
    PlanarScanParams,
    PlanarScan,
    planar_likelihood,
)
from badger_amcl.sensors.point_cloud import (  # noqa: F401
    PointCloudParams,
    point_cloud_likelihood,
)
