#!/usr/bin/env python3
"""On-device smoke test: drive the AMCL main path once on one NVIDIA GPU at
full width, hold every stage to the plain reference, and time the stages.

Run from the repository root:

    python chip_smoke.py               # one GPU: phases 1-5 below
    python chip_smoke.py --four-cards  # four GPUs: the sharded fleet only

Phases of the one-GPU run, all in this process except the CLI child:

1. Device check. Prints `nvidia-smi`'s card name and power limit, the JAX
   version and the device kind, and fails unless JAX's first device is a
   GPU (JAX falls back to the CPU with only a warning).
2. Flagship step at full width: 50k particles x 720 beams, likelihood-field
   model, 1024^2 map. Compiles `mcl.sensor_resample_step_jit` and
   `mcl.mcl_step_2d_jit` for the GPU, prints compile times and memory
   analyses, compares the GPU's likelihoods with the same jitted function
   on the CPU device, a sample with the float64 reference
   (badger_amcl/reference.py), and the resampled cloud with the weighted
   input cloud.
3. Every planar model and both 3D models, GPU against CPU over every
   particle x beam pair, plus a float64 sample.
4. The served path: the CLI (`python -m badger_amcl --sim`) as a child
   process, run before this process touches JAX so one process holds the
   card at a time; then `Node2D` from examples/amcl_2d.yaml on a 2048^2
   warehouse map (supersampled x2 by the config) for 100 scans, its global
   localization service and a restart from the saved pose; then `Node3D`
   from examples/amcl_3d.yaml for a few clouds.
5. Stage times, each with its own warm-up and block_until_ready.

Any failed check raises and the run exits non-zero. Only when every phase
passed is the last line of stdout the JSON object
`{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}`.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Flagship and model-phase widths (bench.py's flagship config)
N_FLAGSHIP, B_FLAGSHIP, MAP_CELLS = 50000, 720, 1024
N_BEAM = 5000
N_3D_TRACK, N_3D_SPREAD, B_3D = 10000, 50000, 256
N_PAIRS = 2000  # float64 sample of (particle, beam) pairs
# Served path: a ~100 m warehouse floor at 0.05 m, 100 scans
SERVED_CELLS, SERVED_SCANS = 2048, 100
# Fleet: 256 robots x 10k particles, 180 beams (benchmarks/run_all.py)
FLEET_R, FLEET_N, FLEET_B = 256, 10000, 180

CLOUDS = {  # pose covariance (x, y, yaw) of the three regimes (bench.py)
    "steady": (0.004, 0.004, 0.0004),
    "tracking": (0.02, 0.02, 0.002),
    "spread": (2.0, 2.0, 1.0),
}

# Tolerances. GPU and CPU run the same float32 program; sums of up to 720
# terms are taken in another order (rtol 1e-5). An endpoint within float32
# rounding of a cell boundary can land in the neighbouring cell when the
# two compilers round sin/cos or contract a multiply-add (FMA) differently:
# such lookups must stay rare and differ by at most one cell step, and the
# particles they touch are left out of the rtol comparison.
RTOL_DEVICE = 1e-5
# A Bresenham range is hypot(cell steps) * resolution; each device rounds
# its sqrt, so ranges to the same cell agree within a few float32 ulp.
RANGE_ROUNDING = 1e-6
MIN_EQUAL_LOOKUPS = 0.999
MAX_FLIPPED_PARTICLES = 0.005
# float32 against float64: a 720-term float32 sum of positive terms is
# within B * 2^-24 (~4.3e-5) of exact, exp and the endpoint trig add a few
# ulp; rtol 1e-4 covers both. Endpoints within 1e-4 cells of a boundary
# are set apart (float32 coordinates resolve ~1e-5 cells on these maps).
RTOL_F64 = 1e-4
F64_MARGIN = 1e-4
# With 720 beams about a quarter of the particles have some endpoint that
# close to a boundary; at most this share may be set apart.
F64_MAX_APART = 0.6
MC_SIGMAS = 6.0  # Monte-Carlo tolerance: standard errors of an n-draw resample


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def log(msg=""):
    print(msg, flush=True)


def card_info():
    """`nvidia-smi` name and power limit, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi lists no GPU")
    return out


def _with_cpu_backend():
    """Keep the CPU backend available beside the GPU for the reference
    runs, whatever JAX_PLATFORMS names (call before importing jax)."""
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"


# --------------------------------------------------------------- helpers


def _put(tree, device):
    import jax

    return jax.device_put(tree, device)


def compare_lookups(name, a, b, max_step, rounding=0.0):
    """a, b: (N, B) per-pair lookups from two devices. A pair matches when
    the values agree within `rounding` (relative; 0 = bit-equal) and has
    moved otherwise. Returns the (N,) mask of particles with a moved pair."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    diff = ~np.isclose(a, b, rtol=rounding, atol=0.0)
    equal = 1.0 - diff.mean()
    worst = float(np.max(np.abs(a - b)[diff])) if diff.any() else 0.0
    rounded = int(np.sum((a != b) & ~diff))
    log(f"  {name}: {int(diff.sum())} of {diff.size} lookups moved "
        f"({equal * 100:.5f} % match"
        + (f"; {rounded} more differ within rtol {rounding:g}" if rounding else "")
        + f"), largest move {worst:.6g} (one cell step {max_step:.6g})"
        + ("; an endpoint on a cell boundary moved a cell (trig rounding or FMA)"
           if diff.any() else ""))
    check(equal >= MIN_EQUAL_LOOKUPS,
          f"{name}: only {equal * 100:.4f} % of lookups agree")
    check(worst <= max_step * (1 + 1e-6) + 1e-7,
          f"{name}: a lookup differs by {worst} > one cell step {max_step}")
    return diff.any(axis=1)


def compare_values(name, dev, ref, flipped, rtol=RTOL_DEVICE,
                   max_apart=MAX_FLIPPED_PARTICLES, floor=None):
    """Per-particle values of the device against the reference: within
    rtol wherever no lookup differed, and at most `max_apart` of the
    particles set apart. Values below `floor` compare as `floor`."""
    dev = np.asarray(dev, np.float64)
    ref = np.asarray(ref, np.float64)
    if floor is not None:
        dev, ref = np.maximum(dev, floor), np.maximum(ref, floor)
    check(dev.shape == ref.shape, f"{name}: shapes {dev.shape} vs {ref.shape}")
    check(np.isfinite(dev).all() == np.isfinite(ref).all(),
          f"{name}: finiteness differs")
    keep = ~flipped & np.isfinite(ref)
    err = np.abs(dev - ref)[keep]
    scale = np.abs(ref)[keep]
    rel = np.where(scale > 0, err / np.where(scale > 0, scale, 1.0), err)
    worst = float(rel.max()) if rel.size else 0.0
    frac = float(flipped.mean())
    log(f"  {name}: {int(keep.sum())} particles compared, max rel diff "
        f"{worst:.3g} (rtol {rtol:g}); {int(flipped.sum())} set apart "
        f"({frac * 100:.3f} %) for a lookup that moved or lies on a cell boundary")
    check(worst <= rtol, f"{name}: relative difference {worst} > {rtol}")
    check(frac <= max_apart,
          f"{name}: {frac * 100:.3f} % of particles touched a moved lookup")


def mc_check(name, samples, ref_points, ref_weights):
    """The equally weighted `samples` (n, 3) against the weighted reference
    cloud: mean and covariance within MC_SIGMAS standard errors of an n-draw
    resample of that cloud."""
    s = np.asarray(samples, np.float64)
    x = np.asarray(ref_points, np.float64)
    w = np.asarray(ref_weights, np.float64)
    w = w / w.sum()
    n = s.shape[0]
    mu = w @ x
    stats = [("mean " + "xya"[k], lambda v, k=k: v[:, k]) for k in range(3)]
    stats += [(f"cov {'xya'[i]}{'xya'[j]}",
               lambda v, i=i, j=j: (v[:, i] - mu[i]) * (v[:, j] - mu[j]))
              for i, j in ((0, 0), (1, 1), (2, 2), (0, 1))]
    worst = 0.0
    for label, g in stats:
        gx = g(x)
        expect = w @ gx
        se = math.sqrt(max(w @ (gx - expect) ** 2, 0.0) / n) + 1e-9
        z = abs(float(np.mean(g(s))) - expect) / se
        worst = max(worst, z)
        check(z <= MC_SIGMAS, f"{name}: {label} is {z:.2f} standard errors "
              f"from the weighted input cloud (limit {MC_SIGMAS})")
    log(f"  {name}: n={n}, mean and covariance within {worst:.2f} standard "
        f"errors of the weighted input cloud (limit {MC_SIGMAS:g})")


def time_stage(label, card, fn, *args, iters=10):
    """Warm up (compile) once, then time `iters` calls, each ending in
    block_until_ready. Prints and returns the median in ms."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(times))
    log(f"stage {label}: median {med!r} ms, min {min(times)!r} ms over "
        f"{iters} calls (first call with compile {compile_s:.2f} s) [{card}]")
    return med


def on_both(fn, args, dev, ref):
    """Run one jitted `fn` on each device (its inputs committed there) and
    return both results as numpy pytrees."""
    import jax

    f = jax.jit(fn)
    return tuple(jax.tree.map(np.asarray, f(*_put(args, d))) for d in (dev, ref))


def planar_lookups(poses, omap, sp, scan):
    """(N, B) distance-LUT value at every beam endpoint: the likelihood
    field's gather, exactly as the LF-family models compute it."""
    from badger_amcl.sensors import planar

    spose = planar.coord_add(sp.scanner_pose, poses)
    return planar.beam_endpoint_distances(omap, scan, spose)[0].T


def beam_ranges(poses, omap, sp, scan):
    """(N, B) Bresenham map ranges, cast as the beam model casts them."""
    from badger_amcl.sensors import planar, raycast

    spose = planar.coord_add(sp.scanner_pose, poses)
    return raycast.calc_range(omap, spose[:, 0:1], spose[:, 1:2],
                              spose[:, 2:3] + scan.angles[None, :], scan.range_max)


def cloud_lookups(poses, omap, points):
    """(N, B) voxel-LUT value at every transformed cloud point."""
    from badger_amcl.sensors.point_cloud import transform_cloud_to_map

    return omap.distance_at(omap.world_to_map(transform_cloud_to_map(points, poses)))


def planar_model(label, dev, ref, setup, model, moved, beamskip=False,
                 log_space=False, n_f64=128):
    """One planar model over every particle x beam pair, GPU against CPU;
    `moved` marks particles with a lookup that differs between them. Then
    the first `n_f64` particles against the float64 reference (beam
    skipping counts agreement over the whole cloud, so those cases are
    held to the CPU only)."""
    import jax.numpy as jnp

    from badger_amcl import reference
    from badger_amcl.sensors.planar import planar_likelihood

    omap, _, state, scan, sp, _ = setup
    n = state.poses.shape[0]

    def fn(poses, omap, sp, scan):
        return planar_likelihood(
            omap, sp, scan, poses, jnp.ones((n,), bool), jnp.int32(n), model,
            converged=jnp.asarray(beamskip), do_beamskip=beamskip,
            prob_log_space=log_space)

    (p_dev, mf_dev), (p_ref, mf_ref) = on_both(
        fn, (state.poses, omap, sp, scan), dev, ref)
    compare_values(f"{label} GPU vs CPU", p_dev, p_ref, moved)
    check(np.array_equal(mf_dev, mf_ref), f"{label}: map factors differ")
    if beamskip:
        return
    poses = np.asarray(state.poses)[:n_f64]
    p64 = reference.planar_likelihood(
        omap, sp, scan.ranges, scan.angles, scan.range_max, poses, model,
        log_space=log_space)
    apart = near_boundary(omap, sp, scan, poses, rays=model == "beam")
    # the linear prob model's product of beam terms underflows float32:
    # below its smallest normal number the float64 value is not reachable
    linear_prob = model == "likelihood_field_prob" and not log_space
    compare_values(f"{label} GPU vs float64", p_dev[:n_f64], p64, apart,
                   rtol=RTOL_F64, max_apart=F64_MAX_APART,
                   floor=np.finfo(np.float32).tiny if linear_prob else None)


def near_boundary(omap, sp, scan, poses, rays=False):
    """(N,) particles with a valid beam endpoint within F64_MARGIN cells of
    a cell boundary (float64). With `rays`, the beam model's start and
    max-range cells instead: the cells Bresenham walks between are exact
    integers, so only those two can move."""
    from badger_amcl import reference

    spose = reference.scanner_poses(sp.scanner_pose, poses)
    ranges = np.asarray(scan.ranges, np.float64)
    if rays:
        trials = (np.zeros_like(ranges), np.full_like(ranges, float(scan.range_max)))
        beams = np.ones(ranges.shape, bool)
    else:
        trials, beams = (ranges,), ranges < float(scan.range_max)
    near = np.zeros(poses.shape[0], bool)
    for r in trials:
        _, _, margin = reference.planar_distances(omap, r, scan.angles, spose)
        near |= (margin[:, beams] < F64_MARGIN).any(axis=1)
    return near


def pair_sample(label, omap, sp, scan, poses, z_dev, n_pairs, seed):
    """`n_pairs` sampled (particle, beam) lookups of the device against the
    float64 reference: equal unless the endpoint lies within F64_MARGIN
    cells of a boundary."""
    from badger_amcl import reference

    rng = np.random.default_rng(seed)
    pi = rng.integers(0, poses.shape[0], n_pairs)
    bi = rng.integers(0, z_dev.shape[1], n_pairs)
    spose = reference.scanner_poses(sp.scanner_pose, poses[pi])
    z64, _, margin = reference.planar_distances(omap, scan.ranges, scan.angles, spose)
    rows = np.arange(n_pairs)
    near = margin[rows, bi] < F64_MARGIN
    bad = (z_dev[pi, bi] != z64[rows, bi]) & ~near
    log(f"  {label}: {n_pairs} sampled (particle, beam) lookups against float64: "
        f"{int(near.sum())} within {F64_MARGIN:g} cells of a boundary, "
        f"{int(bad.sum())} differ elsewhere")
    check(not bad.any(), f"{label}: lookups differ from the float64 reference")


# -------------------------------------------------------- phase 2: flagship


def flagship(dev, ref, n=N_FLAGSHIP, b=B_FLAGSHIP, map_cells=MAP_CELLS,
             n_pairs=N_PAIRS, seed=0):
    """Phase 2. Returns the setup and the moved-lookup mask for phase 3."""
    import jax.numpy as jnp

    from __graft_entry__ import _build_setup
    from badger_amcl import mcl, reference

    log(f"phase 2: flagship step {n} x {b}, likelihood field, {map_cells}^2 map")
    setup = _build_setup(n, b, map_cells, seed=seed)
    omap, params, state, scan, sp, pool = setup
    motion = (jnp.array([0.1, 0.0, 0.02], jnp.float32),) * 3 \
        + (jnp.full((5,), 0.1, jnp.float32),)
    args = (state, omap, sp, scan, pool)
    on_dev, on_ref = _put(args, dev), _put(args, ref)

    def compile_for_device(jitted, dyn):
        t0 = time.perf_counter()
        c = jitted.lower(*dyn, params=params).compile()
        log(f"  {jitted.__name__}: compiled for {dev.platform} in "
            f"{time.perf_counter() - t0:.2f} s; {c.memory_analysis()}")
        return c

    sr = compile_for_device(mcl.sensor_resample_step_jit, on_dev)
    step = compile_for_device(mcl.mcl_step_2d_jit, on_dev + _put(motion, dev))

    # likelihoods over all n x b pairs, GPU against CPU
    z_dev, z_ref = on_both(planar_lookups, (state.poses, omap, sp, scan), dev, ref)
    moved = compare_lookups("flagship lookups GPU vs CPU", z_dev, z_ref,
                            omap.resolution * math.sqrt(2.0))
    p_dev, p_ref = on_both(mcl.likelihood_only, args[:4], dev, ref)
    compare_values("flagship likelihood x map factor GPU vs CPU", p_dev, p_ref, moved)

    poses = np.asarray(state.poses)
    pair_sample("flagship", omap, sp, scan, poses, z_dev, n_pairs, seed)
    k = 256
    p64 = reference.planar_likelihood(
        omap, sp, scan.ranges, scan.angles, scan.range_max, poses[:k],
        "likelihood_field") * reference.planar_map_factors(omap, sp, poses[:k])
    compare_values("flagship likelihood x map factor GPU vs float64", p_dev[:k],
                   p64, near_boundary(omap, sp, scan, poses[:k]), rtol=RTOL_F64,
                   max_apart=F64_MAX_APART)

    # the resample step: KLD count and the resampled cloud
    out = sr(*on_dev)
    out_ref = mcl.sensor_resample_step_jit(*on_ref, params=params)
    n_dev, n_cpu = int(out.n_active), int(out_ref.n_active)
    n64 = reference.kld_sample_count(
        np.asarray(out.poses), params.min_samples, params.max_samples,
        params.pop_err, params.pop_z)
    log(f"  KLD count: GPU {n_dev}, CPU {n_cpu}, float64 recount of the GPU's "
        f"draws {n64} (limits {params.min_samples}..{params.max_samples})")
    check(params.min_samples <= n_dev <= params.max_samples, "KLD count out of range")
    check(abs(n_dev - n64) <= max(2, 0.005 * n64),
          "KLD count disagrees with the float64 recount of the same draws")
    check(abs(n_dev - n_cpu) <= max(2, 0.02 * n_cpu),
          "KLD count differs between GPU and CPU")
    mc_check("flagship resample", np.asarray(out.poses)[:n_dev], poses, p_dev)
    check(np.isfinite(np.asarray(out.stats.cov)).all(), "non-finite cluster statistics")

    moved_dev = step(*on_dev, *_put(motion, dev))
    moved_ref = mcl.mcl_step_2d_jit(*on_ref, *_put(motion, ref), params=params)
    nm, nr = int(moved_dev.n_active), int(moved_ref.n_active)
    a = np.asarray(moved_dev.poses, np.float64)[:nm]
    r = np.asarray(moved_ref.poses, np.float64)[:nr]
    check(params.min_samples <= nm <= params.max_samples, "mcl_step_2d n_active")
    check(np.isfinite(a).all(), "mcl_step_2d poses not finite")
    se = np.sqrt(a.var(axis=0) / nm + r.var(axis=0) / nr) + 1e-9
    zmax = float(np.max(np.abs(a.mean(axis=0) - r.mean(axis=0)) / se))
    log(f"  mcl_step_2d: n_active GPU {nm}, CPU {nr}; pose means {zmax:.2f} "
        f"standard errors apart (limit {MC_SIGMAS:g})")
    check(zmax <= MC_SIGMAS, "mcl_step_2d pose mean differs between GPU and CPU")
    return setup, moved


# ---------------------------------------------------------- phase 3: models


def make_3d_setup(n, cov, b=B_3D, seed=0):
    """A 20 m x 20 m x 1 m voxel world of random occupied points at 0.05 m,
    a b-point cloud within 4 m and 0.1-0.9 m high, and an n-particle filter
    around (10, 10) (benchmarks/run_all.py's 3D configuration)."""
    import jax
    import jax.numpy as jnp

    from badger_amcl.maps import OctoMap3D
    from badger_amcl.pf import PFParams, init_with_gaussian
    from badger_amcl.sensors.point_cloud import PointCloudParams

    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 20.0, (20000, 3)) * np.array([1, 1, 0.05])
    omap = OctoMap3D.from_occupied_points(
        pts, 0.05, 0.36, metric_min=(0, 0, 0), metric_max=(20, 20, 1.0)
    ).with_distance_field()
    params = PFParams(min_samples=n, max_samples=n)
    state = init_with_gaussian(params, jax.random.PRNGKey(seed),
                               jnp.array([10.0, 10.0, 0.0]), jnp.diag(jnp.asarray(cov)))
    ang = rng.uniform(-np.pi, np.pi, b)
    r = rng.uniform(0.5, 4.0, b)
    # heights within 0.45 voxel of a layer centre: a point's layer is the
    # same for every particle, so one height on a voxel boundary would set
    # the whole cloud apart in the float64 comparison
    zs = (rng.integers(2, 18, b) + rng.uniform(-0.45, 0.45, b)) * 0.05
    cloud = jnp.asarray(np.stack([r * np.cos(ang), r * np.sin(ang), zs], axis=1),
                        jnp.float32)
    return omap, PointCloudParams(), cloud, state, params


def cloud_model(label, dev, ref, setup, model, moved, n_f64=128):
    """One 3D model, GPU against CPU over every particle x point pair, then
    the first n_f64 particles against the float64 reference."""
    from badger_amcl import reference
    from badger_amcl.sensors.point_cloud import point_cloud_likelihood

    omap, pc, cloud, state, _ = setup

    def fn(poses, omap, pc, cloud):
        return point_cloud_likelihood(omap, pc, cloud, poses, model)

    (p_dev, mf_dev), (p_ref, mf_ref) = on_both(fn, (state.poses, omap, pc, cloud),
                                               dev, ref)
    compare_values(f"{label} GPU vs CPU", p_dev, p_ref, moved)
    check(np.array_equal(mf_dev, mf_ref), f"{label}: map factors differ")
    poses = np.asarray(state.poses)[:n_f64]
    p64 = reference.point_cloud_likelihood(omap, pc, np.asarray(cloud), poses, model)
    _, margin = reference.point_cloud_distances(omap, np.asarray(cloud), poses)
    compare_values(f"{label} GPU vs float64", p_dev[:n_f64], p64,
                   (margin < F64_MARGIN).any(axis=1), rtol=RTOL_F64,
                   max_apart=F64_MAX_APART)


def models(dev, ref, flagship_setup, flagship_moved, n=N_FLAGSHIP,
           n_beam=N_BEAM, n_3d=(N_3D_TRACK, N_3D_SPREAD), b_3d=B_3D,
           map_cells=MAP_CELLS, n_f64=128):
    """Phase 3: every planar model and both 3D models."""
    from __graft_entry__ import _build_setup

    b = flagship_setup[3].ranges.shape[0]
    log(f"phase 3: measurement models, GPU against CPU over every pair")
    for label, model, kw in (
        ("likelihood_field", "likelihood_field", {}),
        ("likelihood_field_gompertz", "likelihood_field_gompertz", {}),
        ("likelihood_field_prob log-space", "likelihood_field_prob",
         dict(log_space=True)),
        ("likelihood_field_prob log-space beamskip", "likelihood_field_prob",
         dict(log_space=True, beamskip=True)),
    ):
        planar_model(f"{label} {n} x {b}", dev, ref, flagship_setup, model,
                     flagship_moved, n_f64=n_f64, **kw)

    # the linear prob model underflows float32 past ~60 beams (every p is
    # 0), so it is compared at the production launch's 60 beams
    setup60 = _build_setup(n, 60, map_cells)
    omap, _, state, scan, sp, _ = setup60
    z_dev, z_ref = on_both(planar_lookups, (state.poses, omap, sp, scan), dev, ref)
    moved60 = compare_lookups(f"lookups {n} x 60 GPU vs CPU", z_dev, z_ref,
                              omap.resolution * math.sqrt(2.0))
    for label, kw in (("likelihood_field_prob", {}),
                      ("likelihood_field_prob beamskip", dict(beamskip=True))):
        planar_model(f"{label} {n} x 60", dev, ref, setup60,
                     "likelihood_field_prob", moved60, n_f64=n_f64, **kw)

    # beam model: exact Bresenham
    setup_b = _build_setup(n_beam, b, map_cells, pose_cov=CLOUDS["tracking"],
                           min_particles=n_beam)
    omap, _, state, scan, sp, _ = setup_b
    r_dev, r_ref = on_both(beam_ranges, (state.poses, omap, sp, scan), dev, ref)
    moved_b = compare_lookups(f"beam map ranges {n_beam} x {b} GPU vs CPU",
                              r_dev, r_ref, omap.resolution * math.sqrt(2.0),
                              rounding=RANGE_ROUNDING)
    planar_model(f"beam {n_beam} x {b}", dev, ref, setup_b, "beam", moved_b,
                 n_f64=min(n_f64, 8))

    for n3, regime in zip(n_3d, ("tracking", "spread")):
        setup3 = make_3d_setup(n3, CLOUDS[regime], b_3d)
        omap3, _, cloud, state3, _ = setup3
        z_dev, z_ref = on_both(cloud_lookups, (state3.poses, omap3, cloud), dev, ref)
        moved3 = compare_lookups(
            f"3D lookups {regime} {n3} x {b_3d} GPU vs CPU", z_dev, z_ref,
            omap3.resolution * math.sqrt(3.0) + omap3.max_distance_ratio)
        for model in ("likelihood_field", "likelihood_field_gompertz"):
            cloud_model(f"3D {model} {regime} {n3} x {b_3d}", dev, ref, setup3,
                        model, moved3, n_f64=n_f64)


# ------------------------------------------------------ phase 4: served path


def cli_child(steps=30):
    """`python -m badger_amcl --sim` with the production 2D config as a
    child process, in a scratch directory (it saves its pose there). Run
    before this process touches JAX, so only one process holds the card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "badger_amcl", "--sim", "--steps", str(steps),
           "--seed", "0", "--config", os.path.join(REPO, "examples", "amcl_2d.yaml")]
    log(f"phase 4a: {' '.join(cmd[1:])} (child process)")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True,
                              text=True, timeout=900)
        wall = time.perf_counter() - t0
    lines = (proc.stdout + proc.stderr).strip().splitlines()
    for line in lines[-6:]:
        log(f"  | {line}")
    check(proc.returncode == 0, f"CLI child exited {proc.returncode}")
    check(any("JAX device: gpu" in line for line in lines),
          "the CLI child did not run on a GPU")
    poses = [line for line in lines if " pose (" in line and " true (" in line]
    check(poses, "the CLI child published no pose")
    est, true = (np.array(part.split(")")[0].split(", "), float) for part in
                 poses[-1].split(" pose (")[1].split(" true ("))
    err = math.hypot(*(est[:2] - true[:2]))
    log(f"  CLI child: {steps} sim steps, exit 0, {wall:.1f} s wall with "
        f"start-up; last logged pose {err:.4f} m from the truth (bound 0.5 m)")
    check(err < 0.5, "the CLI child lost the robot")


def warehouse_grid(n=SERVED_CELLS, res=0.05, seed=11):
    """An n x n OccupancyGrid centred on the origin: border walls, rack
    rows (1.2 m deep, 3 m aisles, 10 m runs with 2 m cross aisles) outside
    a 28 m open square, and 0.4 m pillars in that square outside a 3.5 m
    disk around the origin, where the robot drives."""
    from badger_amcl.node.messages import OccupancyGrid

    data = np.zeros((n, n), np.int8)
    data[:4, :] = data[-4:, :] = 100
    data[:, :4] = data[:, -4:] = 100
    c = n // 2
    open_half = int(14.0 / res)
    rack, aisle, run, cross = (int(v / res) for v in (1.2, 3.0, 10.0, 2.0))
    for y in range(8, n - 8 - rack, rack + aisle):
        for x in range(8, n - 8 - run, run + cross):
            if abs(y + rack / 2 - c) < open_half and abs(x + run / 2 - c) < open_half:
                continue
            data[y:y + rack, x:x + run] = 100
    rng = np.random.default_rng(seed)
    placed = 0
    while placed < 60:
        x, y = rng.uniform(-12.0, 12.0, 2)
        if math.hypot(x, y) < 4.1:  # the pillar's far corner stays outside 3.5 m
            continue
        i, j = int(x / res) + c, int(y / res) + c
        data[j:j + 8, i:i + 8] = 100
        placed += 1
    return OccupancyGrid(width=n, height=n, resolution=res, origin_x=-n * res / 2,
                         origin_y=-n * res / 2, data=data.ravel())


def _pose_error(est, true):
    return (math.hypot(est[0] - true[0], est[1] - true[1]),
            abs(math.remainder(est[2] - true[2], 2 * math.pi)))


def served_2d(cells=SERVED_CELLS, scans=SERVED_SCANS, restart_scans=10,
              bound=(0.3, 0.2)):
    """Node2D from the production config, fed the way cli.run_sim feeds it;
    then a restart from the saved pose and the global localization
    service."""
    from badger_amcl.cli import load_config
    from badger_amcl.node import make_node
    from badger_amcl.sim import Sim2D

    grid = warehouse_grid(cells)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_config(os.path.join(REPO, "examples", "amcl_2d.yaml")).replace(
            saved_pose_filepath=os.path.join(tmp, "saved_pose.yaml"))
        log(f"phase 4b: Node2D, examples/amcl_2d.yaml ({cfg.min_particles}.."
            f"{cfg.max_particles} particles, {cfg.laser_max_beams} beams, "
            f"{cfg.laser_model_type.value}), {cells}^2 map at "
            f"{grid.resolution} m x{cfg.map_scale_up_factor} supersampling, "
            f"{scans} scans")
        start = (0.0, -2.0, 0.0)
        sim = Sim2D(grid, start_pose=start, base_frame=cfg.base_frame_id)
        node = make_node(cfg, tf_buffer=sim.tf, seed=0)
        node.init_pose = np.array(start)
        node.init_cov = np.array([0.25, 0.25, 0.05])
        t0 = time.perf_counter()
        node.map_msg_received(grid)
        log(f"  map received: {node.map.size_x}^2 cells, distance field and "
            f"free space baked in {time.perf_counter() - t0:.1f} s")

        def drive(nd, k):
            t0 = time.perf_counter()
            for _ in range(k):
                nd.integrate_odom(sim.step(0.3, 0.15))
                nd.scan_received(sim.make_scan())
                nd.spin_once(sim.t)
            return time.perf_counter() - t0

        wall = drive(node, scans)
        exy, eth = _pose_error(node.last_published_pose.pose, sim.true_pose)
        log(f"  after {scans} scans: pose error {exy:.4f} m, {eth:.4f} rad "
            f"(bound {bound[0]} m, {bound[1]} rad); n_active "
            f"{int(node.state.n_active)}; {wall:.2f} s host wall incl. compiles; "
            f"phases {_phases(node)}")
        check(exy < bound[0] and eth < bound[1], "Node2D lost the robot")
        node.shutdown(sim.t)

        node2 = make_node(cfg, tf_buffer=sim.tf, seed=1)
        exy0, _ = _pose_error(node2.init_pose, sim.true_pose)
        log(f"  restart: saved pose loaded {exy0:.4f} m from the truth")
        check(exy0 < 0.5, "restart did not load the saved pose")
        node2.map_msg_received(grid)
        drive(node2, restart_scans)
        exy, eth = _pose_error(node2.last_published_pose.pose, sim.true_pose)
        log(f"  restart + {restart_scans} scans: pose error {exy:.4f} m, {eth:.4f} rad")
        check(exy < bound[0] and eth < bound[1], "restarted Node2D lost the robot")

        node2.global_localization()
        spread = np.asarray(node2.state.poses)[:int(node2.state.n_active)].std(axis=0)
        drive(node2, 5)
        poses = np.asarray(node2.state.poses)[:int(node2.state.n_active)]
        log(f"  global localization: {int(node2.state.n_active)} particles, "
            f"initial spread {spread[0]:.1f} m x {spread[1]:.1f} m; 5 scans later "
            f"{poses.shape[0]} finite particles")
        side = cells * grid.resolution  # uniform over the side: std side/sqrt(12)
        check(min(spread[:2]) > 0.2 * side,
              "global localization did not spread the particles over the map")
        check(np.isfinite(poses).all(), "global localization produced non-finite poses")


def _phases(node):
    return ", ".join(f"{k} {v['mean_ms']:.2f} ms x{v['count']}"
                     for k, v in node.timers.report().items())


def voxel_world(size=10.0, res=0.1, height=1.2, seed=7):
    """Occupied voxel centres of a walled size x size room with ten columns
    (examples/demo_node_3d.py's world)."""
    rng = np.random.default_rng(seed)
    n, nz = int(size / res), int(height / res)
    ax = (np.arange(n) + 0.5) * res
    zs = (np.arange(nz) + 0.5) * res
    walls = []
    for z in zs:
        for fixed in (0.5 * res, size - 0.5 * res):
            walls.append(np.stack([ax, np.full(n, fixed), np.full(n, z)], axis=1))
            walls.append(np.stack([np.full(n, fixed), ax, np.full(n, z)], axis=1))
    cols = [np.array([[cx, cy, z] for z in zs]) for cx, cy in
            rng.uniform(1.5, size - 1.5, (10, 2))]
    return np.concatenate(walls + cols), res


def served_3d(clouds=20, bound=0.3):
    """Node3D from the production 3D config on a synthetic voxel room."""
    from badger_amcl.cli import load_config
    from badger_amcl.node import make_node
    from badger_amcl.node.messages import OctomapMsg
    from badger_amcl.sim import Sim3D

    pts, res = voxel_world()
    with tempfile.TemporaryDirectory() as tmp:
        # update gating relaxed from 0.25 m / 0.5 rad so that every cloud
        # updates the filter
        cfg = load_config(os.path.join(REPO, "examples", "amcl_3d.yaml")).replace(
            saved_pose_filepath=os.path.join(tmp, "saved_pose.yaml"),
            update_min_d=0.05, update_min_a=0.05)
        log(f"phase 4c: Node3D, examples/amcl_3d.yaml ({cfg.min_particles}.."
            f"{cfg.max_particles} particles, {cfg.resolved_cloud_max_beams} "
            f"points), {len(pts)} occupied voxels, {clouds} clouds")
        sim = Sim3D(pts, res, start_pose=(3.0, 3.0, 0.5), n_points=256,
                    base_frame=cfg.base_frame_id)
        node = make_node(cfg, tf_buffer=sim.tf)
        node.init_pose = sim.true_pose.copy()
        node.init_cov = np.array([0.2, 0.2, 0.05])
        node.octomap_msg_received(OctomapMsg(resolution=res, occupied_centers=pts))
        for _ in range(clouds):
            node.integrate_odom(sim.step(0.25, 0.2))
            node.scan_received(sim.make_cloud())
            node.spin_once(sim.t)
        _, est = node.get_max_weight_pose()
        exy, eth = _pose_error(est, sim.true_pose)
        log(f"  after {clouds} clouds: pose error {exy:.4f} m, {eth:.4f} rad "
            f"(bound {bound} m); n_active {int(node.state.n_active)}; "
            f"phases {_phases(node)}")
        check(exy < bound, "Node3D lost the robot")


# ------------------------------------------------------- phase 5: stage times


def stage_times(card, n=N_FLAGSHIP, b=B_FLAGSHIP, n_beam=N_BEAM,
                n_3d=(N_3D_TRACK, N_3D_SPREAD), b_3d=B_3D, map_cells=MAP_CELLS,
                fleet=(FLEET_R, FLEET_N, FLEET_B), iters=10):
    """Phase 5: each stage from a fixed input state (population pinned at
    min == max so every call does full-size work), warmed up, then timed
    call by call with block_until_ready."""
    import functools

    import jax

    from __graft_entry__ import _build_setup
    from badger_amcl import mcl
    from badger_amcl.pf import filter as pf_filter
    from badger_amcl.sensors.planar import planar_likelihood
    from badger_amcl.sensors.point_cloud import point_cloud_likelihood

    log("phase 5: stage times (host clock around block_until_ready)")
    for regime in ("steady", "tracking", "spread"):
        omap, params, state, scan, sp, pool = _build_setup(
            n, b, map_cells, pose_cov=CLOUDS[regime], min_particles=n)
        step = jax.jit(functools.partial(mcl.sensor_resample_step, params=params))
        time_stage(f"lf_{regime}_{n}x{b}", card, step, state, omap, sp, scan,
                   pool, iters=iters)
        if regime == "tracking":
            like = jax.jit(mcl.likelihood_only)
            time_stage(f"lf_likelihood_tracking_{n}x{b}", card, like, state,
                       omap, sp, scan, iters=iters)

            def prob_log(s, omap, sp, scan, pool, params=params):
                logp, mf = planar_likelihood(
                    omap, sp, scan, s.poses, s.active_mask, s.n_active,
                    "likelihood_field_prob", converged=s.converged,
                    prob_log_space=True)
                s = pf_filter.sensor_update_log(s, logp, mf)
                return pf_filter.resample(s, params, pool, log_averages=True)

            time_stage(f"prob_log_{n}x{b}", card, jax.jit(prob_log),
                       pf_filter.init_log_averages(state), omap, sp, scan, pool,
                       iters=iters)

    for nb, regime in ((n_beam, "tracking"), (n, "spread")):
        omap, params, state, scan, sp, pool = _build_setup(
            nb, b, map_cells, pose_cov=CLOUDS[regime], min_particles=nb)
        step = jax.jit(functools.partial(mcl.sensor_resample_step, params=params,
                                         laser_model="beam"))
        time_stage(f"beam_{regime}_{nb}x{b}", card, step, state, omap, sp, scan,
                   pool, iters=iters)

    for n3, regime in zip(n_3d, ("tracking", "spread")):
        omap3, pc, cloud, state3, params3 = make_3d_setup(n3, CLOUDS[regime], b_3d)

        def step3(s, omap, pc, cloud, pool, params=params3):
            p, mf = point_cloud_likelihood(omap, pc, cloud, s.poses, "likelihood_field")
            return pf_filter.resample(pf_filter.sensor_update(s, p, mf), params, pool)

        time_stage(f"3d_{regime}_{n3}x{b_3d}", card, jax.jit(step3), state3,
                   omap3, pc, cloud, jax.numpy.zeros((n3, 3)), iters=iters)

    fleet_times(card, *fleet, iters=max(3, iters // 2))


def fleet_setup(r, n, b, map_cells=MAP_CELLS):
    """benchmarks/run_all.py's fleet: r robots x n particles, b beams, a
    per-robot KLD grid of 32 x 32 x 40 and the cluster cap of 128."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _build_setup
    from badger_amcl.fleet import fleet_init
    from badger_amcl.pf.types import PFParams
    from badger_amcl.sensors.planar import PlanarScan

    omap, _, _, scan, sp, _ = _build_setup(64, b, map_cells)
    params = PFParams(min_samples=max(n // 100, 1), max_samples=n, hist_x=32,
                      hist_y=32, stats_max_clusters=128)
    key = jax.random.PRNGKey(0)
    means = 0.1 * jax.random.normal(key, (r, 3))
    covs = jnp.tile(jnp.diag(jnp.array(CLOUDS["tracking"])), (r, 1, 1))
    states = fleet_init(params, key, means, covs)
    scans = PlanarScan(ranges=jnp.tile(scan.ranges, (r, 1)),
                       angles=jnp.tile(scan.angles, (r, 1)),
                       range_max=jnp.full((r,), float(scan.range_max)))
    odom_deltas = jnp.tile(jnp.array([0.05, 0.0, 0.01]), (r, 1))
    args = (states, omap, sp, scans, jnp.zeros((r, n, 3)), jnp.zeros((r, 3)),
            odom_deltas, odom_deltas, jnp.full((5,), 0.05))
    return params, args


def fleet_times(card, r, n, b, iters=5):
    """The fleet step: every robot's full MCL step, vmapped on one card."""
    from badger_amcl.fleet import make_fleet_step

    params, args = fleet_setup(r, n, b)
    ms = time_stage(f"fleet_{r}x{n}", card, make_fleet_step(params), *args,
                    iters=iters)
    log(f"  fleet: {r / ms * 1e3:.1f} robot-steps/s")


# ------------------------------------------------------- four cards: fleet


def four_cards(devices, r=FLEET_R, n=FLEET_N, b=FLEET_B):
    """The fleet sharded over a 1-D ("fleet",) mesh of four GPUs against
    the same inputs on one GPU."""
    import functools

    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from badger_amcl import mcl
    from badger_amcl.fleet import make_fleet_step, make_sharded_fleet_step
    from badger_amcl.fleet.fleet import fleet_health

    check(len(devices) == 4, f"--four-cards needs four devices, JAX sees {devices}")
    log(f"four cards: fleet {r} x {n}, {b} beams, sharded over a ('fleet',) "
        "mesh of 4 GPUs against one GPU")
    mesh = Mesh(np.array(devices), ("fleet",))
    params, args = fleet_setup(r, n, b)
    sharded = NamedSharding(mesh, P("fleet"))
    replicated = NamedSharding(mesh, P())
    robot_axis = (True, False, False, True, True, True, True, True, False)
    args_mesh = tuple(jax.device_put(a, sharded if ax else replicated)
                      for a, ax in zip(args, robot_axis))
    args_one = jax.device_put(args, devices[0])

    # sensor stage: the same vmapped step without resampling, partitioned
    # over the mesh by jit, against one GPU
    sense = jax.jit(jax.vmap(
        functools.partial(mcl.mcl_step_2d, params=params, do_resample=False),
        in_axes=(0, None, None, 0, 0, 0, 0, 0, None)))
    w_mesh = np.asarray(sense(*args_mesh).weights, np.float64)
    w_one = np.asarray(sense(*args_one).weights, np.float64)
    rel = np.abs(w_mesh - w_one) / np.maximum(np.abs(w_one), 1e-30)
    log(f"  post-sensor-update weights: max rel diff {rel.max():.3g} "
        f"(rtol {RTOL_DEVICE:g}) over {w_one.size} particles")
    check(np.allclose(w_mesh, w_one, rtol=RTOL_DEVICE, atol=0.0),
          "sharded sensor update differs from one GPU")

    step_mesh = make_sharded_fleet_step(mesh, params)
    t0 = time.perf_counter()
    out = jax.block_until_ready(step_mesh(*args_mesh))
    log(f"  sharded fleet step: first call {time.perf_counter() - t0:.2f} s; "
        f"output on {len(out.poses.sharding.device_set)} devices")
    check(len(out.poses.sharding.device_set) == 4, "fleet output not sharded")
    one = jax.block_until_ready(make_fleet_step(params)(*args_one))

    # post-resample: picks can flip on last-bit weight differences between
    # batch sizes, so the per-robot clouds are compared as samples
    pa, pb = np.asarray(out.poses, np.float64), np.asarray(one.poses, np.float64)
    na, nb = np.asarray(out.n_active), np.asarray(one.n_active)
    worst = 0.0
    for k in range(r):
        a, c = pa[k, :na[k]], pb[k, :nb[k]]
        se = np.sqrt(a.var(axis=0) / na[k] + c.var(axis=0) / nb[k]) + 1e-9
        worst = max(worst, float(np.max(np.abs(a.mean(axis=0) - c.mean(axis=0)) / se)))
        for i, j in ((0, 0), (1, 1), (2, 2), (0, 1)):
            ga = (a[:, i] - a[:, i].mean()) * (a[:, j] - a[:, j].mean())
            gc = (c[:, i] - c[:, i].mean()) * (c[:, j] - c[:, j].mean())
            se = math.sqrt(ga.var() / na[k] + gc.var() / nb[k]) + 1e-12
            worst = max(worst, abs(ga.mean() - gc.mean()) / se)
    identical = int(np.sum(np.all(pa == pb, axis=(1, 2))))
    log(f"  post-resample per-robot pose mean and covariance: worst "
        f"{worst:.2f} standard errors (limit {MC_SIGMAS:g}); {identical} of {r} "
        "robots bit-identical (picks may flip on last-bit weight differences)")
    check(worst <= MC_SIGMAS, "sharded fleet step differs from one GPU")

    health = jax.tree.map(float, fleet_health(out, mesh=mesh))
    w = np.max(np.asarray(out.stats.cluster_weights, np.float64), axis=-1)
    want = {"converged_frac": float(np.mean(np.asarray(out.converged))),
            "mean_active": float(np.mean(na)), "mean_top_weight": float(np.mean(w))}
    log(f"  fleet_health psum: {health}; single-device means: {want}")
    for key, v in want.items():
        check(math.isclose(health[key], v, rel_tol=1e-5, abs_tol=1e-7),
              f"fleet_health {key}: psum {health[key]} vs mean {v}")


# ---------------------------------------------------------------------- main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the fleet sharded over four GPUs")
    args = ap.parse_args(argv)

    cards = card_info()
    log("phase 1: device check")
    for line in cards:
        log(line)
    if not args.four_cards:
        cli_child()

    _with_cpu_backend()
    import jax

    from badger_amcl.utils.runtime import enable_compile_cache, require_gpu

    log(f"  compile cache: {enable_compile_cache()}")
    devices = jax.devices()
    dev = require_gpu(devices[0])
    log(f"  jax {jax.__version__}; {len(devices)} x {dev.device_kind}")
    if args.four_cards:
        for d in devices:
            require_gpu(d)
        four_cards(devices)
    else:
        ref = jax.devices("cpu")[0]
        setup, moved = flagship(dev, ref)
        models(dev, ref, setup, moved)
        served_2d()
        served_3d()
        stage_times(cards[0])
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
