from badger_amcl.sim.simulator import Sim2D, Sim3D, make_room_grid  # noqa: F401
