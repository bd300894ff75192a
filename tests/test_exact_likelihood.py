"""The exact float32 XLA likelihoods against the float64 numpy reference
(badger_amcl/reference.py), for every planar and 3D model in the steady,
tracking and spread clouds, plus the map-factor paths.

An endpoint that lies within float32 rounding of a cell boundary may land
in the neighbouring cell; particles with such an endpoint (within 1e-4
cells in float64) are set apart and must stay a minority. The rest agree
within rtol 1e-4: a B-term float32 sum of positive terms is within
B * 2^-24 of exact, and exp and the endpoint trig add a few ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from badger_amcl import reference
from badger_amcl.maps import CellState, OccupancyMap2D, OctoMap3D
from badger_amcl.sensors.planar import (
    PlanarScan, PlanarScanParams, bake_factor_texture, map_factors, planar_likelihood,
)
from badger_amcl.sensors.point_cloud import PointCloudParams, point_cloud_likelihood

RTOL = 1e-4
MARGIN = 1e-4
CLOUDS = {
    "steady": (0.004, 0.004, 0.0004),
    "tracking": (0.02, 0.02, 0.002),
    "spread": (2.0, 2.0, 1.0),
}


@pytest.fixture(scope="module")
def room():
    """8 m x 8 m at 0.05 m: border walls, eight pillars, a 2 m field."""
    rng = np.random.default_rng(3)
    cells = np.full((160, 160), int(CellState.FREE), np.int8)
    cells[:2, :] = cells[-2:, :] = int(CellState.OCCUPIED)
    cells[:, :2] = cells[:, -2:] = int(CellState.OCCUPIED)
    for cx, cy in rng.integers(10, 140, (8, 2)):
        cells[cy:cy + 8, cx:cx + 8] = int(CellState.OCCUPIED)
    return OccupancyMap2D.from_cells(cells, 0.05).with_distance_field(2.0)


@pytest.fixture(scope="module")
def voxels():
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 6.0, (3000, 3)) * np.array([1, 1, 0.15])
    return OctoMap3D.from_occupied_points(
        pts, 0.05, 0.36, metric_min=(0, 0, 0), metric_max=(6, 6, 1.0)
    ).with_distance_field()


def _cloud(regime, n, center=(0.3, -0.2, 0.4), seed=0):
    rng = np.random.default_rng(seed)
    std = np.sqrt(np.asarray(CLOUDS[regime]))
    return (np.asarray(center) + rng.standard_normal((n, 3)) * std).astype(np.float32)


def _scan(b, range_max=6.0, seed=1):
    rng = np.random.default_rng(seed)
    angles = np.linspace(-2.3, 2.3, b).astype(np.float32)
    ranges = rng.uniform(0.3, 3.5, b).astype(np.float32)
    ranges[::11] = range_max  # max-range readings
    return PlanarScan(ranges=jnp.asarray(ranges), angles=jnp.asarray(angles),
                      range_max=jnp.float32(range_max))


def _compare(got, want, apart):
    got = np.asarray(got, np.float64)
    keep = ~apart
    assert keep.mean() >= 0.5, f"only {keep.sum()} of {keep.size} particles comparable"
    np.testing.assert_allclose(got[keep], want[keep], rtol=RTOL)


# model, beams, particles, likelihood kwargs
PLANAR_CASES = {
    "beam": ("beam", 24, 20, {}),
    "likelihood_field": ("likelihood_field", 48, 200, {}),
    "gompertz": ("likelihood_field_gompertz", 48, 200, {}),
    "prob": ("likelihood_field_prob", 24, 200, {}),
    "prob_log": ("likelihood_field_prob", 48, 200, dict(prob_log_space=True)),
    "prob_log_beamskip": ("likelihood_field_prob", 48, 200,
                          dict(prob_log_space=True, do_beamskip=True)),
}


@pytest.mark.parametrize("regime", list(CLOUDS))
@pytest.mark.parametrize("case", list(PLANAR_CASES))
def test_planar_likelihood_matches_float64_reference(room, case, regime):
    model, b, n, kw = PLANAR_CASES[case]
    params = PlanarScanParams(
        gompertz_a=jnp.float32(0.941), gompertz_b=jnp.float32(5.0),
        gompertz_c=jnp.float32(3.0), input_shift=jnp.float32(-0.97),
        input_scale=jnp.float32(2.0), output_shift=jnp.float32(0.25),
        scanner_pose=jnp.array([0.2, 0.05, 0.1], jnp.float32))
    scan = _scan(b)
    poses = _cloud(regime, n)
    beamskip = kw.get("do_beamskip", False)
    got, _ = jax.jit(lambda p: planar_likelihood(
        room, params, scan, p, jnp.ones((n,), bool), jnp.int32(n), model,
        converged=jnp.asarray(beamskip), **kw))(jnp.asarray(poses))
    want = reference.planar_likelihood(
        room, params, scan.ranges, scan.angles, scan.range_max, poses, model,
        converged=beamskip, do_beamskip=beamskip,
        log_space=kw.get("prob_log_space", False))
    spose = reference.scanner_poses(params.scanner_pose, poses)
    if model == "beam":  # only a ray's start and max-range cells can move
        full = np.full(b, float(scan.range_max))
        margins = [reference.planar_distances(room, r, scan.angles, spose)[2]
                   for r in (np.zeros(b), full)]
        apart = np.any([(m < MARGIN).any(axis=1) for m in margins], axis=0)
    else:
        _, _, margin = reference.planar_distances(room, scan.ranges, scan.angles, spose)
        apart = (margin < MARGIN).any(axis=1)
    if beamskip:  # agreement counts over the whole cloud: nothing set apart
        apart = np.zeros(n, bool)
    if model == "likelihood_field_prob" and not kw:  # float32 underflow
        tiny = np.finfo(np.float32).tiny
        got, want = np.maximum(np.asarray(got, np.float64), tiny), np.maximum(want, tiny)
    _compare(got, want, apart)


@pytest.mark.parametrize("regime", list(CLOUDS))
@pytest.mark.parametrize("model", ["likelihood_field", "likelihood_field_gompertz"])
def test_point_cloud_likelihood_matches_float64_reference(voxels, model, regime):
    rng = np.random.default_rng(2)
    ang = rng.uniform(-np.pi, np.pi, 64)
    r = rng.uniform(0.5, 2.5, 64)
    cloud = np.stack([r * np.cos(ang), r * np.sin(ang), rng.uniform(0.0, 0.5, 64)],
                     axis=1).astype(np.float32)
    poses = _cloud(regime, 150, center=(3.0, 3.0, 0.2))
    params = PointCloudParams(z_hit=jnp.float32(0.5), z_rand=jnp.float32(0.5),
                              sigma_hit=jnp.float32(0.1))
    got, _ = jax.jit(lambda p: point_cloud_likelihood(
        voxels, params, jnp.asarray(cloud), p, model))(jnp.asarray(poses))
    want = reference.point_cloud_likelihood(voxels, params, cloud, poses, model)
    _, margin = reference.point_cloud_distances(voxels, cloud, poses)
    _compare(got, want, (margin < MARGIN).any(axis=1))


@pytest.mark.parametrize("fn, model", [
    (lambda m, p: planar_likelihood(
        m, PlanarScanParams(), _scan(8), p, jnp.ones((4,), bool), jnp.int32(4), "corr"),
     "planar"),
    (lambda m, p: reference.planar_likelihood(
        m, PlanarScanParams(), np.ones(4), np.zeros(4), 6.0, p, "corr"), "reference"),
])
def test_unknown_model_raises(room, fn, model):
    with pytest.raises(ValueError, match="unknown planar model"):
        fn(room, jnp.zeros((4, 3), jnp.float32))


@pytest.mark.parametrize("cloud", ["tight", "loose", "off_map"])
def test_map_factors_windowed_matches_classic_and_reference(room, cloud):
    """Tight clouds take the one-hot window read, loose ones the gather;
    both equal the float64 recalcWeight (particles exactly on a cell
    boundary excepted)."""
    params = PlanarScanParams(off_map_factor=jnp.float32(0.1),
                              non_free_space_factor=jnp.float32(0.3),
                              non_free_space_radius=jnp.float32(0.4))
    rng = np.random.default_rng(9)
    n = 300
    if cloud == "tight":  # within one 32 x 128-cell window
        xy = rng.uniform(-0.6, 0.6, (n, 2)) * np.array([1.0, 0.5])
    elif cloud == "loose":
        xy = rng.uniform(-3.8, 3.8, (n, 2))
    else:  # a third of the cloud off the map
        xy = rng.uniform(-6.0, 6.0, (n, 2))
    poses = np.concatenate([xy, rng.uniform(-3, 3, (n, 1))], axis=1).astype(np.float32)
    got = np.asarray(map_factors(room, params, jnp.asarray(poses)))
    got_baked = np.asarray(jax.jit(map_factors)(
        bake_factor_texture(room, params), params, jnp.asarray(poses)))
    np.testing.assert_array_equal(got, got_baked)
    want = reference.planar_map_factors(room, params, poses)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if cloud == "off_map":
        assert np.sum(want == np.float32(0.1)) > n // 10
