"""Minimal end-to-end 2D localization demo.

A robot drives a scripted loop inside a synthetic occupancy map; laser scans
are generated by raycasting the true pose against the same map; the MCL
filter consumes noisy odometry + scans and must track the true pose.

Run:  python examples/demo_2d_localization.py [--kidnap] [--platform cpu]
"""

import argparse
import math
import sys

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None,
                    help="JAX platform; default: the accelerator if present")
    ap.add_argument("--kidnap", action="store_true", help="teleport the robot mid-run")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--particles", type=int, default=2000)
    # Production-grade defaults (mirror the shipped launch configs:
    # resample_model_type systematic, resample every update). A weaker
    # config — 60 beams, multinomial every 2nd update — recovers the
    # kidnapped robot's position but can lose the yaw-mirror race: the
    # wrong mode is a genuine local optimum and multinomial variance +
    # sparse beams let it out-refine the reacquired true mode.
    ap.add_argument("--beams", type=int, default=120)
    ap.add_argument("--resample-model", default="systematic",
                    choices=["systematic", "multinomial"])
    ap.add_argument("--resample-every", type=int, default=1)
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp

    from badger_amcl.maps import CellState, OccupancyMap2D
    from badger_amcl.pf import PFParams, init_with_gaussian, resample, sensor_update
    from badger_amcl.pf.filter import ResampleModel, max_weight_cluster
    from badger_amcl.sensors import (
        OdomModel,
        PlanarScan,
        PlanarScanParams,
        motion_update,
        planar_likelihood,
    )
    from badger_amcl.sensors.raycast import calc_range

    # --- world: 12x12 m room with pillars, 0.05 m cells ------------------
    # Pillars are kept clear of both scripted arcs (plain start and
    # post-kidnap): the "true" robot follows its script blindly, and a
    # step inside a pillar raycasts garbage scans no filter could match.
    n = 240
    res = 0.05
    cells = np.full((n, n), int(CellState.FREE), np.int8)
    cells[0:2, :] = cells[-2:, :] = int(CellState.OCCUPIED)
    cells[:, 0:2] = cells[:, -2:] = int(CellState.OCCUPIED)
    # Asymmetric landmark: a 3 m wall stub from the west wall at y=+3.5 m.
    # A square room's walls are self-similar under 90-degree rotation, and
    # random pillars are too weak a cue for the LF model: a kidnapped
    # filter measurably re-converges onto a pi/2-rotated ALIAS of the true
    # pose (est yaw error locks at 1.57) and, once converged, w_fast
    # recovers and injection stops — correct augmented-MCL behavior in a
    # genuinely ambiguous world. The stub makes the true mode uniquely
    # best. It clears both scripted arcs (pre-kidnap circle tops out at
    # y=1.9; post-kidnap at x>=-1.3).
    cells[188:192, 0:60] = int(CellState.OCCUPIED)
    arc_r = 0.15 / 0.06  # v/w of the scripted motion below
    arcs = []  # (center_x, center_y) of each scripted circle
    for px, py, pth in ((-3.0, -3.0, 0.3), (3.0, 3.0, 2.35)):
        arcs.append((px - arc_r * math.sin(pth), py + arc_r * math.cos(pth)))
    rng = np.random.default_rng(42)
    placed = 0
    while placed < 12:
        cx, cy = rng.integers(30, n - 30, 2)
        wx, wy = ((cx + 4) - n / 2) * res, ((cy + 4) - n / 2) * res
        if any(abs(math.hypot(wx - ax, wy - ay) - arc_r) < 0.6
               for ax, ay in arcs):
            continue
        cells[cy : cy + 8, cx : cx + 8] = int(CellState.OCCUPIED)
        placed += 1
    world = OccupancyMap2D.from_cells(cells, res).with_distance_field(2.0)

    B = args.beams
    beam_angles = jnp.linspace(-math.pi * 0.75, math.pi * 0.75, B)
    range_max = 8.0

    def make_scan(true_pose, key):
        r = calc_range(
            world,
            jnp.float32(true_pose[0]),
            jnp.float32(true_pose[1]),
            jnp.float32(true_pose[2]) + beam_angles,
            range_max,
        )
        noise = 0.01 * jax.random.normal(key, (B,))
        r = jnp.clip(r + noise, 0.0, range_max)
        return PlanarScan(ranges=r, angles=beam_angles, range_max=jnp.float32(range_max))

    # --- filter -----------------------------------------------------------
    params = PFParams(min_samples=100, max_samples=args.particles)
    scan_params = PlanarScanParams()
    alphas = (0.1, 0.1, 0.1, 0.1, 0.1)
    key = jax.random.PRNGKey(0)
    true_pose = np.array([-3.0, -3.0, 0.3])
    key, k1 = jax.random.split(key)
    # recovery averages (recovery_alpha_slow/fast rosparams): the w_slow
    # time constant must be shorter than the tracking phase before the
    # kidnap, or w_slow never reaches w_avg and w_diff = 1 - w_fast/w_slow
    # stays pinned at 0 (no random-pose injection, no recovery) — with the
    # reference's documented 0.001/0.1 defaults a kidnap at step 30 is
    # unrecoverable by construction, at ANY particle count
    state = init_with_gaussian(
        params, k1, jnp.asarray(true_pose, jnp.float32),
        jnp.diag(jnp.array([0.25, 0.25, 0.06])),
        alpha_slow=0.05, alpha_fast=0.5,
    )

    fsi = world.free_space_indices(0.2)
    fsi_j = jnp.asarray(fsi)

    def random_pose_pool(key, m):
        k1, k2 = jax.random.split(key)
        idx = (jax.random.uniform(k1, (m,)) * fsi_j.shape[0]).astype(jnp.int32)
        xy = world.map_to_world(fsi_j[idx])
        yaw = jax.random.uniform(k2, (m,)) * 2 * math.pi - math.pi
        return jnp.concatenate([xy, yaw[:, None]], axis=1)

    odom_pose = true_pose.copy()
    resample_count = 0
    errs = []
    print(f"{'step':>4} {'true_x':>7} {'true_y':>7} {'est_x':>7} {'est_y':>7} "
          f"{'err_xy':>7} {'err_th':>7} {'n_act':>6} {'conv':>5}")
    for step in range(args.steps):
        # scripted motion: arc
        v, w = 0.15, 0.06
        true_pose[0] += v * math.cos(true_pose[2])
        true_pose[1] += v * math.sin(true_pose[2])
        true_pose[2] += w

        if args.kidnap and step == 30:
            # heading chosen so the post-kidnap arc (radius v/w = 2.5 m,
            # center at pose + 2.5 * (-sin th, cos th)) stays INSIDE the
            # 12 m room: center (1.23, 1.23), max |coord| 3.73 m. The old
            # heading -2.0 put the circle center at (5.3, 2.0) — the "true"
            # robot drove through the east wall and off the map every loop,
            # feeding the filter garbage scans it could never match.
            true_pose = np.array([3.0, 3.0, 2.35])
            print("   -- KIDNAPPED: teleported to (3.0, 3.0, 2.35) --")

        # noisy odometry delta (odom frame drifts but deltas are ~truth+noise)
        key, ko = jax.random.split(key)
        d = np.asarray(jax.random.normal(ko, (3,))) * np.array([0.01, 0.01, 0.004])
        if args.kidnap and step == 30:
            delta = np.array([v * math.cos(odom_pose[2]), v * math.sin(odom_pose[2]), w]) + d
        else:
            delta = np.array(
                [v * math.cos(odom_pose[2]), v * math.sin(odom_pose[2]), w]
            ) + d
        odom_pose = odom_pose + delta

        state = motion_update(
            state, OdomModel.DIFF, alphas, jnp.asarray(odom_pose, jnp.float32),
            jnp.asarray(delta, jnp.float32),
        )

        key, ks = jax.random.split(key)
        scan = make_scan(true_pose, ks)
        p, mf = planar_likelihood(
            world, scan_params, scan, state.poses, state.active_mask,
            state.n_active, "likelihood_field",
        )
        state = sensor_update(state, p, mf)

        resample_count += 1
        if resample_count % args.resample_every == 0:
            key, kp = jax.random.split(key)
            pool = random_pose_pool(kp, params.max_samples)
            model = (ResampleModel.SYSTEMATIC
                     if args.resample_model == "systematic"
                     else ResampleModel.MULTINOMIAL)
            state = resample(state, params, pool, model)

        wgt, mean = max_weight_cluster(state.stats)
        est = np.asarray(mean)
        exy = float(np.hypot(est[0] - true_pose[0], est[1] - true_pose[1]))
        eth = float(abs(math.remainder(est[2] - true_pose[2], 2 * math.pi)))
        errs.append((exy, eth))
        print(f"{step:>4} {true_pose[0]:>7.2f} {true_pose[1]:>7.2f} "
              f"{est[0]:>7.2f} {est[1]:>7.2f} {exy:>7.3f} {eth:>7.3f} "
              f"{int(state.n_active):>6} {str(bool(state.converged)):>5}")

    tail = np.array(errs[-10:])
    print(f"\nfinal-10 mean err: xy={tail[:,0].mean():.3f} m, th={tail[:,1].mean():.3f} rad")
    ok = tail[:, 0].mean() < 0.15 and tail[:, 1].mean() < 0.1
    print("LOCALIZED" if ok else "LOST")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
