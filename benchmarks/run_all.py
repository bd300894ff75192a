"""Full benchmark suite: the BASELINE.json configurations.

1. 2D likelihood-field AMCL, reference CPU default scale (500 x 180)
2. 2D beam model (exact Bresenham raycasting), tracking (5k x 720) and
   global localization (50k x 720 spread cloud)
3. KLD-adaptive global localization, particle sweep 100 -> 50k
4. 3D point-cloud localization, tracking (10k particles x 256 points,
   voxel EDT) and spread (50k x 256 global-localization-scale cloud)
5. Fleet batch: 256 robots x 10k particles (vmapped; sharded across the mesh
   when more than one device is present)

Run on a GPU:  python benchmarks/run_all.py
Prints one JSON object per config plus a summary line; exits non-zero if any
config failed.
"""

import argparse
import json
import os
import sys
import time
import traceback

# runnable from anywhere: the repo root holds the package + __graft_entry__
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _time_chain(step, state, iters=100, env=None):
    """Interleaved TWO-POINT chained slope: the chain runs inside ONE jit'd
    fori_loop with a TRACED trip count, timed at iters and 4*iters in
    lo,hi,hi,lo order — cancels fixed per-call costs AND their linear drift.

    env: big pytrees (map textures, scans, pools) passed as jit ARGUMENTS
    instead of python closures — closure constants embed in the HLO as
    literals and bloat every compile."""
    import jax
    import jax.numpy as jnp

    args = () if env is None else (env,)

    @jax.jit
    def loop(s, n, *a):
        return jax.lax.fori_loop(0, n, lambda i, t: step(t, *a), s)

    lo, hi = jnp.int32(iters), jnp.int32(4 * iters)
    s = loop(state, lo, *args)
    jax.block_until_ready(s)

    def run(n):
        nonlocal s
        t0 = time.perf_counter()
        s = loop(s, n, *args)
        jax.block_until_ready(s)
        return time.perf_counter() - t0

    w_lo1, w_hi1, w_hi2, w_lo2 = run(lo), run(hi), run(hi), run(lo)
    return ((w_hi1 + w_hi2) - (w_lo1 + w_lo2)) / 2.0 / (3 * iters), s


def bench_2d_lf():
    from __graft_entry__ import _build_setup
    from badger_amcl import mcl

    omap, params, state, scan, sp, pool = _build_setup(
        500, 180, 1024, pose_cov=(0.02, 0.02, 0.002), min_particles=500
    )
    env = (omap, scan, pool)
    dt, _ = _time_chain(
        lambda s, e: mcl.sensor_resample_step(
            s, e[0], sp, e[1], e[2], params),
        state, env=env,
    )
    return {"config": "2d_lf_500x180", "step_ms": dt * 1e3,
            "evals_per_sec": 500 * 180 / dt}


def bench_2d_beam():
    from __graft_entry__ import _build_setup
    from badger_amcl import mcl

    omap, params, state, scan, sp, pool = _build_setup(
        5000, 720, 1024, pose_cov=(0.02, 0.02, 0.002), min_particles=5000
    )
    env = (omap, scan, pool)
    dt, _ = _time_chain(
        lambda s, e: mcl.sensor_resample_step(
            s, e[0], sp, e[1], e[2], params, laser_model="beam"),
        state, iters=30, env=env,
    )
    return {"config": "2d_beam_5000x720", "step_ms": dt * 1e3,
            "evals_per_sec": 5000 * 720 / dt}


def bench_2d_beam_spread():
    """Beam-model GLOBAL LOCALIZATION (50k x 720 spread cloud) through the
    exact Bresenham ray bundle."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _build_setup
    from badger_amcl import mcl

    n = 50000
    omap, params, state, scan, sp, pool = _build_setup(
        n, 720, 1024, pose_cov=(2.0, 2.0, 1.0), min_particles=n
    )
    env = (omap, scan, pool, state.poses)

    @jax.jit
    def step(s, env):
        omap_e, scan_e, pool_e, poses0 = env
        s2 = mcl.sensor_resample_step(
            s, omap_e, sp, scan_e, pool_e, params, laser_model="beam")
        # pin the spread cloud (a resample collapses it; bench.py pattern)
        return s2.replace(
            poses=poses0 + jnp.mean(s2.poses) * 1e-12,
            weights=jnp.full_like(s2.weights, 1.0 / n),
            n_active=jnp.int32(n),
        )

    dt, _ = _time_chain(step, state, iters=30, env=env)
    return {"config": "2d_beam_spread_50000x720", "step_ms": dt * 1e3,
            "evals_per_sec": n * 720 / dt}


def bench_2d_prob_log():
    """likelihood_field_prob at 720 beams via the log-space-resident weight
    pipeline (round-5 capability: the default exp path underflows f32 past
    ~60 beams and uniform-resets forever; pf/filter.py sensor_update_log).
    Parity evidence vs an f64 CPU oracle: tests/test_prob_log.py."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _build_setup
    from badger_amcl.pf import filter as pf_filter
    from badger_amcl.sensors.planar import planar_likelihood

    n = 50000
    omap, params, state, scan, sp, pool = _build_setup(
        n, 720, 1024, pose_cov=(0.02, 0.02, 0.002), min_particles=n
    )
    state = pf_filter.init_log_averages(state)
    env = (omap, scan, pool)

    def step(s, env):
        omap_e, scan_e, pool_e = env
        logp, mf = planar_likelihood(
            omap_e, sp, scan_e, s.poses, s.active_mask, s.n_active,
            "likelihood_field_prob", converged=s.converged,
            prob_log_space=True)
        s2 = pf_filter.sensor_update_log(s, logp, mf)
        return pf_filter.resample(s2, params, pool_e, log_averages=True)

    dt, _ = _time_chain(step, state, iters=30, env=env)
    return {"config": "2d_prob_log_50000x720", "step_ms": dt * 1e3,
            "evals_per_sec": n * 720 / dt}


def bench_kld_sweep():
    from __graft_entry__ import _build_setup
    from badger_amcl import mcl

    out = []
    for n in (100, 1000, 10000, 50000):
        omap, params, state, scan, sp, pool = _build_setup(
            n, 180, 1024, pose_cov=(4.0, 4.0, 1.5), min_particles=max(50, n // 100)
        )
        env = (omap, scan, pool)
        dt, s_end = _time_chain(
            lambda s, e: mcl.sensor_resample_step(
                s, e[0], sp, e[1], e[2], params),
            state, iters=20, env=env,
        )
        out.append({"max_particles": n, "step_ms": dt * 1e3,
                    "n_active_end": int(s_end.n_active)})
    return {"config": "kld_global_localization_sweep", "sweep": out}


def _bench_3d_shape(n, b, cov, regime, iters=100, pin_poses=False):
    """Shared 3D benchmark body. pin_poses keeps the regime's pose cloud
    across iterations (a spread cloud collapses after the first resample —
    chaining raw steps would silently measure tracking instead; the bench.py
    pinned-step pattern)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from badger_amcl.maps import OctoMap3D
    from badger_amcl.pf import PFParams, init_with_gaussian, sensor_update
    from badger_amcl.pf import filter as pf_filter
    from badger_amcl.sensors.point_cloud import PointCloudParams, point_cloud_likelihood

    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 20.0, (20000, 3)) * np.array([1, 1, 0.05])
    omap = OctoMap3D.from_occupied_points(
        pts, 0.05, 0.36, metric_min=(0, 0, 0), metric_max=(20, 20, 1.0)
    ).with_distance_field()
    params = PFParams(min_samples=n, max_samples=n)
    state = init_with_gaussian(
        params, jax.random.PRNGKey(0), jnp.array([10.0, 10.0, 0.0]),
        jnp.diag(jnp.asarray(cov)),
    )
    ang = rng.uniform(-np.pi, np.pi, b)
    r = rng.uniform(0.5, 4.0, b)
    zs = rng.uniform(0.1, 0.9, b)
    cloud = jnp.asarray(np.stack([r * np.cos(ang), r * np.sin(ang), zs], axis=1),
                        jnp.float32)
    pc_params = PointCloudParams()
    pool = jnp.zeros((n, 3))
    poses0 = state.poses

    @jax.jit
    def step(s):
        p, mf = point_cloud_likelihood(omap, pc_params, cloud, s.poses,
                                       "likelihood_field")
        s = sensor_update(s, p, mf)
        s2 = pf_filter.resample(s, params, pool)
        if pin_poses:
            s2 = s2.replace(
                poses=poses0 + jnp.mean(s2.poses) * 1e-12,
                weights=jnp.full_like(s2.weights, 1.0 / n),
                n_active=jnp.int32(n),
            )
        return s2

    dt, _ = _time_chain(step, state, iters=iters)
    return {"config": f"3d_cloud_{regime}_{n}x{b}", "step_ms": dt * 1e3,
            "evals_per_sec": n * b / dt}


def bench_3d():
    """3D tracking row (the production 3D config scale, node_3d.cpp:58-94)."""
    return _bench_3d_shape(10000, 256, (0.02, 0.02, 0.002),
                           "tracking")


def bench_3d_spread():
    """3D spread row (50k x 256 global-localization-scale cloud)."""
    return _bench_3d_shape(50000, 256, (2.0, 2.0, 1.0),
                           "spread", iters=30, pin_poses=True)


def bench_fleet():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from __graft_entry__ import _build_setup
    from badger_amcl.fleet import fleet_init, make_fleet_step, make_sharded_fleet_step
    from badger_amcl.pf.types import PFParams
    from badger_amcl.sensors.planar import PlanarScan, PlanarScanParams

    r, n, b = 256, 10000, 180
    omap, _, _, scan, sp, _ = _build_setup(64, b, 1024)
    # smaller per-robot KLD grid: tracking robots spread far less than the
    # single-robot default allows, and the grid is the fleet's memory-
    # bandwidth bottleneck under vmap
    params = PFParams(min_samples=n // 100, max_samples=n, hist_x=32, hist_y=32,
                      stats_max_clusters=128)
    key = jax.random.PRNGKey(0)
    means = 0.1 * jax.random.normal(key, (r, 3))
    covs = jnp.tile(jnp.diag(jnp.array([0.02, 0.02, 0.002])), (r, 1, 1))
    states = fleet_init(params, key, means, covs)
    scans = PlanarScan(
        ranges=jnp.tile(scan.ranges, (r, 1)),
        angles=jnp.tile(scan.angles, (r, 1)),
        range_max=jnp.full((r,), float(scan.range_max)),
    )
    pools = jnp.zeros((r, n, 3))
    odom_poses = jnp.zeros((r, 3))
    odom_deltas = jnp.tile(jnp.array([0.05, 0.0, 0.01]), (r, 1))
    alphas = jnp.full((5,), 0.05)

    n_dev = len(jax.devices())
    if n_dev > 1:
        mesh = Mesh(np.array(jax.devices()), ("fleet",))
        step_fn = make_sharded_fleet_step(mesh, params, laser_model="likelihood_field")
        states = jax.device_put(states, NamedSharding(mesh, P("fleet")))
    else:
        step_fn = make_fleet_step(params, laser_model="likelihood_field")

    def step(s):
        return step_fn(s, omap, sp, scans, pools, odom_poses, odom_deltas,
                       odom_deltas, alphas)

    dt, _ = _time_chain(step, states, iters=3)
    return {"config": f"fleet_{r}x{n}", "devices": n_dev, "step_ms": dt * 1e3,
            "robot_steps_per_sec": r / dt,
            "evals_per_sec": r * n * b / dt}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma list: 2d_lf,2d_beam,2d_beam_spread,2d_prob_log,"
                         "kld,3d,3d_spread,fleet")
    args = ap.parse_args()
    import jax

    from badger_amcl.utils.runtime import enable_compile_cache, require_gpu

    enable_compile_cache()
    device = require_gpu()
    benches = {
        "2d_lf": bench_2d_lf,
        "2d_beam": bench_2d_beam,
        "2d_beam_spread": bench_2d_beam_spread,
        "2d_prob_log": bench_2d_prob_log,
        "kld": bench_kld_sweep,
        "3d": bench_3d,
        "3d_spread": bench_3d_spread,
        "fleet": bench_fleet,
    }
    wanted = args.only.split(",") if args.only else list(benches)
    results = []
    failed = []
    for name in wanted:
        try:
            res = benches[name]()
        except Exception as e:  # boundary: record, run the rest, exit non-zero
            traceback.print_exc()
            res = {"config": name, "error": f"{type(e).__name__}: {e}"}
            failed.append(name)
        results.append(res)
        print(json.dumps(res), flush=True)
    print(json.dumps({"summary": True, "failed": failed,
                      "device": {"platform": device.platform,
                                 "kind": device.device_kind,
                                 "count": len(jax.devices())},
                      "n": len(results)}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
