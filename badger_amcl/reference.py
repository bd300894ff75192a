"""Float64 numpy transcriptions of the reference's measurement models.

The plain reference that the JAX code is held to: the per-particle loops of
planar_scanner.cpp, point_cloud_scanner.cpp and occupancy_map.cpp written
out over numpy arrays in float64, sharing no code with the JAX path (only
the map data: cell states and the distance LUT the reference also bakes).
The tests compare the exact XLA path with it at small sizes; chip_smoke.py
compares the device with it on a sample at full width.

Endpoint cells are computed in float64 here and in float32 on the device,
so an endpoint that lies within float32 rounding of a cell boundary may
land in the neighbouring cell. `planar_distances` and
`point_cloud_distances` return each endpoint's distance to the nearest
boundary (in cells) so a comparison can set those few pairs apart.
"""

from __future__ import annotations

import math

import numpy as np

from badger_amcl.maps.occupancy_2d import CellState


def _f(x) -> float:
    return float(np.asarray(x))


def _world_to_map(v, origin, resolution, half):
    """floor((v - origin) / res + 0.5) + half (occupancy_map.cpp:90-98),
    plus the distance in cells to the nearest rounding boundary."""
    t = (np.asarray(v, np.float64) - origin) / resolution + 0.5
    cell = np.floor(t)
    margin = np.minimum(t - cell, cell + 1.0 - t)
    return cell.astype(np.int64) + half, margin


def scanner_poses(scanner_pose, poses):
    """coordAdd (planar_scanner.cpp:693-701) of the mount onto (N, 3)
    particle poses, in float64."""
    a = np.asarray(scanner_pose, np.float64)
    p = np.asarray(poses, np.float64)
    c, s = np.cos(p[:, 2]), np.sin(p[:, 2])
    th = p[:, 2] + a[2]
    th = np.arctan2(np.sin(th), np.cos(th))
    return np.stack([p[:, 0] + a[0] * c - a[1] * s,
                     p[:, 1] + a[0] * s + a[1] * c, th], axis=1)


def planar_distances(omap, ranges, angles, spose):
    """Distance-LUT value at every beam endpoint: (z (N, B), in_map (N, B),
    margin (N, B) cells to the nearest cell boundary). Off-map endpoints
    read max_distance (planar_scanner.cpp:295-300)."""
    ranges = np.asarray(ranges, np.float64)[None, :]
    th = spose[:, 2:3] + np.asarray(angles, np.float64)[None, :]
    hx = spose[:, 0:1] + ranges * np.cos(th)
    hy = spose[:, 1:2] + ranges * np.sin(th)
    i, mi = _world_to_map(hx, omap.origin_x, omap.resolution, omap.size_x // 2)
    j, mj = _world_to_map(hy, omap.origin_y, omap.resolution, omap.size_y // 2)
    inside = (i >= 0) & (i < omap.size_x) & (j >= 0) & (j < omap.size_y)
    lut = np.asarray(omap.distances, np.float64)
    z = np.where(inside, lut[np.clip(j, 0, omap.size_y - 1),
                             np.clip(i, 0, omap.size_x - 1)],
                 omap.max_distance_to_object)
    return z, inside, np.minimum(mi, mj)


def gompertz(params, p):
    """applyGompertz (planar_scanner.cpp:540-550)."""
    p = p * _f(params.input_scale) + _f(params.input_shift)
    p = _f(params.gompertz_a) * np.exp(
        -_f(params.gompertz_b) * np.exp(-_f(params.gompertz_c) * p))
    return p + _f(params.output_shift)


def calc_range(omap, ox, oy, oa, max_range):
    """calcRange (occupancy_map.cpp:257-364) for one ray: Bresenham from
    the start cell until a non-free cell or the max-range cell."""
    cells = np.asarray(omap.cells)

    def w2m(x, y):
        i = math.floor((x - omap.origin_x) / omap.resolution + 0.5) + omap.size_x // 2
        j = math.floor((y - omap.origin_y) / omap.resolution + 0.5) + omap.size_y // 2
        return i, j

    def free(i, j):
        if not (0 <= i < omap.size_x and 0 <= j < omap.size_y):
            return False
        return cells[j, i] == int(CellState.FREE)

    x0, y0 = w2m(ox, oy)
    x1, y1 = w2m(ox + max_range * math.cos(oa), oy + max_range * math.sin(oa))
    if x0 == x1 and y0 == y1:
        return max_range
    steep = abs(y1 - y0) > abs(x1 - x0)
    if steep:
        x0, y0, x1, y1 = y0, x0, y1, x1
    deltax, deltay = abs(x1 - x0), abs(y1 - y0)
    error, deltaerr = 0, deltay
    x, y = x0, y0
    xstep = 1 if x0 < x1 else -1
    ystep = 1 if y0 < y1 else -1

    def check(x, y):
        i, j = (y, x) if steep else (x, y)
        return not free(i, j)

    if check(x, y):
        return math.hypot(x - x0, y - y0) * omap.resolution
    while x != x1 + xstep:
        x += xstep
        error += deltaerr
        if 2 * error >= deltax:
            y += ystep
            error -= deltax
        if check(x, y):
            return math.hypot(x - x0, y - y0) * omap.resolution
    return max_range


def planar_likelihood(omap, params, ranges, angles, range_max, poses, model,
                      active=None, converged=False, do_beamskip=False,
                      log_space=False):
    """applyModelToSampleSet (planar_scanner.cpp:141-164) before the map
    factors: per-particle p (N,) float64, or log p for the prob model with
    log_space. `model` is one of sensors.planar.PLANAR_MODELS."""
    ranges = np.asarray(ranges, np.float64)
    angles = np.asarray(angles, np.float64)
    range_max = _f(range_max)
    spose = scanner_poses(params.scanner_pose, poses)
    z_hit, z_rand = _f(params.z_hit), _f(params.z_rand)
    denom = 2.0 * _f(params.sigma_hit) ** 2
    valid = (ranges < range_max) & ~np.isnan(ranges)

    if model == "beam":  # calcBeamModel (:168-234)
        n, b = spose.shape[0], ranges.shape[0]
        map_range = np.array([
            [calc_range(omap, spose[k, 0], spose[k, 1], spose[k, 2] + angles[m],
                        range_max) for m in range(b)]
            for k in range(n)])
        obs = ranges[None, :]
        zerr = obs - map_range
        lam = _f(params.lambda_short)
        pz = z_hit * np.exp(-(zerr * zerr) / denom)
        pz = pz + np.where(zerr < 0, _f(params.z_short) * lam * np.exp(-lam * obs), 0.0)
        pz = pz + np.where(obs == range_max, _f(params.z_max), 0.0)
        pz = pz + np.where(obs < range_max, z_rand / range_max, 0.0)
        return 1.0 + np.sum(pz ** 3, axis=1)

    z, inside, _ = planar_distances(omap, ranges, angles, spose)
    gauss = z_hit * np.exp(-(z * z) / denom)
    if model == "likelihood_field":  # (:236-323)
        pz = gauss + z_rand / range_max
        return 1.0 + np.sum(np.where(valid[None, :], pz ** 3, 0.0), axis=1)
    if model == "likelihood_field_gompertz":  # (:552-640)
        pz = gauss + z_rand
        count = int(np.sum(valid))
        if count == 0:
            return np.ones(spose.shape[0])
        return gompertz(params, np.sum(np.where(valid[None, :], pz, 0.0), axis=1) / count)
    if model != "likelihood_field_prob":
        raise ValueError(f"unknown planar model {model!r}")

    pz = gauss + z_rand / range_max  # calcLikelihoodFieldModelProb (:325-533)
    with np.errstate(divide="ignore"):
        logpz = np.log(pz)
        log_p = np.sum(np.where(valid[None, :], logpz, 0.0), axis=1)
        if do_beamskip and converged:
            n = spose.shape[0]
            act = np.ones(n, bool) if active is None else np.asarray(active, bool)
            agree = inside & (z < _f(params.beam_skip_distance)) \
                & valid[None, :] & act[:, None]
            obs_count = np.sum(agree, axis=0)
            obs_mask = obs_count / max(int(np.sum(act)), 1) \
                > _f(params.beam_skip_threshold)
            skipped = int(np.sum(~obs_mask))
            error = skipped >= ranges.shape[0] * _f(params.beam_skip_error_threshold)
            # invalid beams keep a cleared (zero) temp entry: log 0 = -inf
            log_temp = np.log(np.where(valid[None, :], pz, 0.0))
            use = obs_mask | error
            log_p = np.sum(np.where(use[None, :], log_temp, 0.0), axis=1)
    return log_p if log_space else np.exp(log_p)


def planar_map_factors(omap, params, poses):
    """recalcWeight (planar_scanner.cpp:642-682): off-map, non-free-space
    or radius-interpolated factor per particle, judged on the particle's
    own cell."""
    p = np.asarray(poses, np.float64)
    i, _ = _world_to_map(p[:, 0], omap.origin_x, omap.resolution, omap.size_x // 2)
    j, _ = _world_to_map(p[:, 1], omap.origin_y, omap.resolution, omap.size_y // 2)
    inside = (i >= 0) & (i < omap.size_x) & (j >= 0) & (j < omap.size_y)
    ic = np.clip(i, 0, omap.size_x - 1)
    jc = np.clip(j, 0, omap.size_y - 1)
    state = np.asarray(omap.cells)[jc, ic]
    d = np.asarray(omap.distances, np.float64)[jc, ic]
    nf, radius = _f(params.non_free_space_factor), _f(params.non_free_space_radius)
    interp = np.where(d < radius, nf + d / max(radius, 1e-30) * (1.0 - nf), 1.0)
    f = np.where(state != int(CellState.FREE), nf, interp)
    return np.where(inside, f, _f(params.off_map_factor))


def point_cloud_distances(omap, points_base, poses):
    """Voxel-LUT distance at every transformed cloud point: (z (N, B),
    margin (N, B) cells to the nearest voxel boundary). The particle
    transform is a z-rotation plus xy translation (getMapCloud,
    point_cloud_scanner.cpp:231-248); out-of-volume points read
    max_distance (octomap.cpp:336-350)."""
    pts = np.asarray(points_base, np.float64)
    p = np.asarray(poses, np.float64)
    c, s = np.cos(p[:, 2:3]), np.sin(p[:, 2:3])
    world = np.stack([
        p[:, 0:1] + c * pts[None, :, 0] - s * pts[None, :, 1],
        p[:, 1:2] + s * pts[None, :, 0] + c * pts[None, :, 1],
        np.broadcast_to(pts[None, :, 2], c.shape[:1] + pts.shape[:1]),
    ], axis=-1)
    t = world / omap.resolution + 0.5
    cell = np.floor(t)
    margin = np.min(np.minimum(t - cell, cell + 1.0 - t), axis=-1)
    cell = cell.astype(np.int64)
    lo = np.asarray(omap.min_cells)
    hi = np.asarray(omap.max_cells)
    inside = np.all((cell >= lo) & (cell <= hi), axis=-1)
    rel = np.clip(cell - lo, 0, hi - lo)
    lut = np.asarray(omap.distances_u8)
    ratio = lut[rel[..., 0], rel[..., 1], rel[..., 2]].astype(np.float64)
    z = np.where(inside, ratio * (omap.max_distance_to_object / 255.0),
                 omap.max_distance_to_object)
    return z, margin


def point_cloud_likelihood(omap, params, points_base, poses, model):
    """applyModelToSampleSet (point_cloud_scanner.cpp:106-203) before the
    map factors: per-particle p (N,) float64."""
    z, _ = point_cloud_distances(omap, points_base, poses)
    denom = 2.0 * _f(params.sigma_hit) ** 2
    gauss = _f(params.z_hit) * np.exp(-(z * z) / denom)
    if model == "likelihood_field":  # (:132-167)
        pz = gauss + _f(params.z_rand) / omap.max_distance_to_object
        return 1.0 + np.sum(pz ** 3, axis=1)
    if model == "likelihood_field_gompertz":  # (:169-203)
        pz = gauss + _f(params.z_rand)
        return gompertz(params, np.mean(pz, axis=1))
    raise ValueError(f"unknown point cloud model {model!r}")


# KLD histogram bins (pf_kdtree.cpp:33-56): 0.5 m, 0.5 m, 10 degrees
KLD_BIN = (0.5, 0.5, 10.0 * math.pi / 180.0)


def resample_limit(k, min_samples, max_samples, pop_err, pop_z):
    """resampleLimit (particle_filter.cpp:475-502) for k occupied bins."""
    if k <= 1:
        return max_samples
    b = 2.0 / (9.0 * (k - 1))
    x = 1.0 - b + math.sqrt(b) * pop_z
    n = math.ceil((k - 1) / (2.0 * pop_err) * x ** 3)
    return int(min(max(n, min_samples), max_samples))


def kld_sample_count(draws, min_samples, max_samples, pop_err, pop_z):
    """The sample count the reference's resampling loop stops at
    (particle_filter.cpp:356-420) for candidate poses `draws` (M, 3) in draw
    order: the first n with n > resampleLimit(k_n), k_n being the number of
    histogram bins the first n draws occupy; M if none."""
    keys = np.floor(np.asarray(draws, np.float64) / np.asarray(KLD_BIN))
    seen = set()
    for n, key in enumerate(map(tuple, keys), start=1):
        seen.add(key)
        if n > resample_limit(len(seen), min_samples, max_samples, pop_err, pop_z):
            return n
    return len(keys)
