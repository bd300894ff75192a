from badger_amcl.fleet.fleet import (  # noqa: F401
    fleet_init,
    fleet_reinit_masked,
    fleet_step,
    make_fleet_step,
    make_sharded_fleet_step,
)
