"""Process entry point — the `main.cpp` equivalent (reference src/main.cpp:37-54).

Seeds the RNG, installs SIGINT/SIGTERM handlers that request a clean
shutdown, constructs the node from a YAML config (same parameter names as
the reference's rosparams), runs a data source (built-in simulator, a JSONL
replay file, or the optional ROS bridge), and saves the pose once more on
exit (`attemptSavePose(true)`, main.cpp:51).

Usage:
    python -m badger_amcl --config examples/amcl_2d.yaml --sim
    python -m badger_amcl --config cfg.yaml --replay run.jsonl
    python -m badger_amcl --config cfg.yaml --ros   (needs rospy/rclpy)
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import sys
import time
from typing import Optional

import numpy as np

log = logging.getLogger("badger_amcl")


def load_config(path: Optional[str]):
    from badger_amcl.config import AMCLConfig

    if path is None:
        return AMCLConfig()
    from badger_amcl.utils.yaml_io import load_file

    raw = load_file(path) or {}
    # Accepts the reference's exact rosparam spellings (aliases + declared-
    # but-unread params) so reference launch configs translate 1:1.
    return AMCLConfig.from_params(raw, warn=log.warning)


class _Shutdown:
    """SIGINT/SIGTERM -> requestShutdown (main.cpp:30-35)."""

    def __init__(self):
        self.requested = False
        signal.signal(signal.SIGINT, self._handler)
        signal.signal(signal.SIGTERM, self._handler)

    def _handler(self, signum, frame):
        self.requested = True


def run_sim(node, cfg, steps: int, shutdown: _Shutdown) -> int:
    from badger_amcl.sim import Sim2D, make_room_grid

    grid = make_room_grid()
    sim = Sim2D(grid, start_pose=(-3.0, -3.0, 0.3), base_frame=cfg.base_frame_id)
    node.tf = sim.tf
    node.init_pose = np.array([-3.0, -3.0, 0.3])
    node.map_msg_received(grid)
    for step in range(steps):
        if shutdown.requested:
            break
        odom = sim.step(0.3, 0.15)
        node.integrate_odom(odom)
        node.scan_received(sim.make_scan())
        node.spin_once(sim.t)
        if step % 10 == 9 and node.last_published_pose is not None:
            p = node.last_published_pose.pose
            log.info("step %d pose (%.2f, %.2f, %.2f) true (%.2f, %.2f)",
                     step, p[0], p[1], p[2], sim.true_pose[0], sim.true_pose[1])
    node.shutdown(sim.t)
    return 0


def run_replay(node, cfg, path: str, shutdown: _Shutdown) -> int:
    """Replay a JSONL message log: one JSON object per line with a `topic`
    field (map, scan, cloud, octomap, odom, initialpose, tf,
    global_localization) mirroring the reference's subscriptions."""
    from badger_amcl.node import messages as msgs
    from badger_amcl.node.transforms import Transform

    t = 0.0
    with open(path) as f:
        for line in f:
            if shutdown.requested:
                break
            if not line.strip():
                continue
            rec = json.loads(line)
            topic = rec.get("topic")
            t = float(rec.get("stamp", t))
            if topic == "map":
                node.map_msg_received(msgs.OccupancyGrid(
                    width=rec["width"], height=rec["height"],
                    resolution=rec["resolution"],
                    origin_x=rec.get("origin_x", 0.0),
                    origin_y=rec.get("origin_y", 0.0),
                    data=np.asarray(rec["data"], np.int8),
                ))
            elif topic == "tf":
                node.tf.set_transform(
                    rec["parent"], rec["child"], t,
                    Transform.from_pose2d(rec["pose"]) if len(rec["pose"]) == 3
                    else Transform(np.asarray(rec["pose"][:3]), np.asarray(rec["pose"][3:])),
                )
            elif topic == "tf_static":
                node.tf.set_static(
                    rec["parent"], rec["child"],
                    Transform.from_pose2d(rec["pose"]) if len(rec["pose"]) == 3
                    else Transform(np.asarray(rec["pose"][:3]), np.asarray(rec["pose"][3:])),
                )
            elif topic == "scan":
                node.scan_received(msgs.LaserScan(
                    stamp=t, frame_id=rec.get("frame_id", "laser"),
                    angle_min=rec["angle_min"],
                    angle_increment=rec["angle_increment"],
                    range_min=rec.get("range_min", 0.0),
                    range_max=rec["range_max"],
                    ranges=np.asarray(rec["ranges"], np.float32),
                ))
            elif topic == "cloud":
                node.scan_received(msgs.PointCloud2(
                    stamp=t, frame_id=rec.get("frame_id", "lidar"),
                    points=np.asarray(rec["points"], np.float32),
                ))
            elif topic == "octomap":
                node.octomap_msg_received(msgs.OctomapMsg(
                    resolution=rec["resolution"],
                    occupied_centers=np.asarray(rec["occupied_centers"], float)
                    if "occupied_centers" in rec else None,
                    binary_data=bytes.fromhex(rec["binary_hex"])
                    if "binary_hex" in rec else None,
                ))
            elif topic == "odom":
                node.integrate_odom(msgs.Odometry(t, np.asarray(rec["pose"], float)))
            elif topic == "initialpose":
                node.initial_pose_received(
                    msgs.PoseWithCovarianceStamped.make(
                        t, rec.get("frame_id", "map"), rec["pose"],
                        np.asarray(rec.get("cov3")) if "cov3" in rec else None,
                    ),
                    t,
                )
            elif topic == "global_localization":
                node.global_localization()
            node.spin_once(t)
    node.shutdown(t)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="badger_amcl")
    ap.add_argument("--config", default=None, help="YAML config file")
    ap.add_argument("--sim", action="store_true", help="run the built-in simulator")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--replay", default=None, help="JSONL message log to replay")
    ap.add_argument("--ros", action="store_true", help="bridge to ROS topics")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--seed", type=int, default=None, help="PRNG seed (default: time)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="[%(levelname)s] %(message)s",
    )
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from badger_amcl.utils.runtime import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    log.info("JAX device: %s (%s), %d device(s)", dev.platform,
             dev.device_kind, len(jax.devices()))

    cfg = load_config(args.config)
    # srand48(time(NULL)) equivalent (main.cpp:39): seed from wall clock
    seed = args.seed if args.seed is not None else int(time.time()) & 0x7FFFFFFF
    from badger_amcl.node import make_node

    node = make_node(cfg, seed=seed)
    shutdown = _Shutdown()
    if args.replay:
        return run_replay(node, cfg, args.replay, shutdown)
    if args.ros:
        from badger_amcl.node.ros_bridge import run_ros_bridge

        return run_ros_bridge(node, cfg, shutdown)
    return run_sim(node, cfg, args.steps, shutdown)


if __name__ == "__main__":
    sys.exit(main())
