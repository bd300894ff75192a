"""Full node-layer 2D demo: the framework as a user consumes it.

Feeds OccupancyGrid/Odometry/LaserScan messages into a Node2D (exactly what a
ROS bridge would do), subscribes to amcl_pose / tf outputs, exercises pose
persistence and — with --kidnap — the global_localization service.

Run:  python examples/demo_node_2d.py [--kidnap] [--steps N] [--platform cpu]
"""

import argparse
import math
import sys
import tempfile


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None,
                    help="JAX platform; default: the accelerator if present")
    ap.add_argument("--kidnap", action="store_true")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--particles", type=int, default=2000)
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import os

    import numpy as np

    from badger_amcl.cli import load_config
    from badger_amcl.node import make_node
    from badger_amcl.sim import Sim2D, make_room_grid

    pose_log = []
    tf_log = []

    # The shipped production config (faithful mirror of the reference's
    # badger_amcl_2d.launch): systematic resampling, 2x supersampled map,
    # base_footprint, gompertz measurement constants. Overrides below are
    # sim-scale only (particle count, update cadence, save path).
    cfg = load_config(os.path.join(os.path.dirname(__file__), "amcl_2d.yaml"))
    grid = make_room_grid(n=240, resolution=0.05, n_pillars=12)
    sim = Sim2D(grid, start_pose=(-3.0, -3.0, 0.3), n_beams=180,
                base_frame=cfg.base_frame_id)
    save_path = tempfile.mktemp(suffix=".yaml")
    cfg = cfg.replace(
        min_particles=200,
        max_particles=args.particles,
        update_min_d=0.05,
        update_min_a=0.05,
        saved_pose_filepath=save_path,
        save_pose_to_file_rate=1.0,
    )
    node = make_node(cfg, tf_buffer=sim.tf)
    node.init_pose = np.array([-3.0, -3.0, 0.3])
    node.init_cov = np.array([0.25, 0.25, 0.05])
    node.subscribe_output("amcl_pose", pose_log.append)
    node.subscribe_output("tf", tf_log.append)
    node.map_msg_received(grid)
    print(f"map: {grid.width}x{grid.height} @ {grid.resolution} m; "
          f"filter: {cfg.min_particles}..{cfg.max_particles} particles")

    def err():
        if not pose_log:
            return float("nan"), float("nan")
        est = pose_log[-1].pose
        return (
            math.hypot(est[0] - sim.true_pose[0], est[1] - sim.true_pose[1]),
            abs(math.remainder(est[2] - sim.true_pose[2], 2 * math.pi)),
        )

    kidnap_step = args.steps // 3 if args.kidnap else -1
    for step in range(args.steps):
        v, w = (0.5, 0.4) if args.kidnap and step > kidnap_step else (0.3, 0.15)
        odom = sim.step(v, w)
        node.integrate_odom(odom)
        node.scan_received(sim.make_scan())
        node.spin_once(sim.t)
        if step == kidnap_step:
            sim.teleport((3.0, 3.0, -2.0))
            print(f"-- step {step}: KIDNAPPED to (3.0, 3.0, -2.0); "
                  f"calling global_localization service --")
            node.global_localization()
        if step % 5 == 4:
            exy, eth = err()
            print(f"step {step:>3}: err_xy={exy:6.3f} err_th={eth:6.3f} "
                  f"n={int(node.state.n_active):>5} poses={len(pose_log):>3} "
                  f"tfs={len(tf_log):>3} conv={bool(node.state.converged)}")

    node.shutdown(sim.t)
    exy, eth = err()
    print(f"\nfinal: err_xy={exy:.3f} m, err_th={eth:.3f} rad; "
          f"{len(pose_log)} poses, {len(tf_log)} TFs published; "
          f"pose saved to {save_path}")
    # restart to prove persistence
    node2 = make_node(cfg, tf_buffer=sim.tf)
    print(f"restart: loaded init pose ({node2.init_pose[0]:.2f}, "
          f"{node2.init_pose[1]:.2f}) vs true ({sim.true_pose[0]:.2f}, "
          f"{sim.true_pose[1]:.2f})")
    ok = exy < 0.3 and np.hypot(*(node2.init_pose[:2] - sim.true_pose[:2])) < 0.5
    print("LOCALIZED" if ok else "LOST")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
