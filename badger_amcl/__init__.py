"""badger_amcl — an accelerator-resident adaptive Monte Carlo localization framework.

A from-scratch JAX/XLA re-design of the capability surface of
BadgerTechnologies/badger_amcl (C++/ROS1): KLD-adaptive particle filtering,
five odometry motion models, four planar-laser measurement models, 3D
point-cloud localization against voxel distance fields, augmented-MCL
recovery, global localization, cluster-based hypothesis extraction and pose
persistence — expressed as dense array programs over `(N, 3)` pose arrays
instead of serial per-particle loops.

Layering (bottom-up), mirroring the reference's layer map (SURVEY.md §1):

- ``maps``     — device-resident map textures + distance fields  (L0)
- ``pf``       — pure-functional particle filter core            (L1)
- ``sensors``  — measurement & motion model kernels              (L2)
- ``node``     — host shim: lifecycle, gating, persistence, I/O  (L3)
- ``fleet``    — multi-robot batching & device-mesh sharding     (new)
- ``sim``      — synthetic world harness (replaces ROS topics in tests)
- ``ops``      — one-hot contraction forms of gathers and segment sums
"""

__version__ = "0.1.0"

from badger_amcl.config import AMCLConfig  # noqa: F401
