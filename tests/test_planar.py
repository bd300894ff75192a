"""Planar measurement models: golden single-particle values and semantic
properties of each of the four models, coordAdd, map factors, beam skipping.

Contracts from src/amcl/sensors/planar_scanner.cpp.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from badger_amcl.maps import CellState, OccupancyMap2D
from badger_amcl.sensors.planar import (
    PlanarScan,
    PlanarScanParams,
    apply_gompertz,
    coord_add,
    map_factors,
    planar_likelihood,
)


def _mk_scan(ranges, angles, range_max=5.0):
    return PlanarScan(
        ranges=jnp.asarray(ranges, jnp.float32),
        angles=jnp.asarray(angles, jnp.float32),
        range_max=jnp.float32(range_max),
    )


def _apply(omap, params, scan, poses, model, converged=False, do_beamskip=False):
    poses = jnp.asarray(poses, jnp.float32)
    n = poses.shape[0]
    return planar_likelihood(
        omap, params, scan, poses,
        jnp.ones((n,), bool), jnp.int32(n), model,
        converged=converged, do_beamskip=do_beamskip,
    )


def test_coord_add():
    """coordAdd (planar_scanner.cpp:693-701)."""
    a = jnp.array([1.0, 0.5, 0.1])
    b = jnp.array([[2.0, 3.0, math.pi / 2]])
    c = np.asarray(coord_add(a, b))[0]
    np.testing.assert_allclose(c[0], 2.0 - 0.5, atol=1e-6)
    np.testing.assert_allclose(c[1], 3.0 + 1.0, atol=1e-6)
    np.testing.assert_allclose(c[2], math.pi / 2 + 0.1, atol=1e-6)
    # output angle is normalized
    b2 = jnp.array([[0.0, 0.0, 3.1]])
    c2 = np.asarray(coord_add(jnp.array([0.0, 0.0, 0.2]), b2))[0]
    np.testing.assert_allclose(c2[2], 3.3 - 2 * math.pi, atol=1e-5)


def test_lf_golden_value(box_map):
    """Hand-computed likelihood-field value for one particle, one beam."""
    params = PlanarScanParams()
    # particle at origin facing +x; beam at angle 0 with range 1.0 ->
    # endpoint world (1.0, 0) = inside the pillar region (0.8..1.2) -> d = 0
    scan = _mk_scan([1.0], [0.0])
    p, mf = _apply(box_map, params, scan, [[0.0, 0.0, 0.0]], "likelihood_field")
    pz = 0.95 * 1.0 + 0.05 / 5.0  # z_hit*exp(0) + z_rand/range_max
    np.testing.assert_allclose(float(p[0]), 1.0 + pz**3, rtol=1e-5)
    np.testing.assert_allclose(float(mf[0]), 1.0)

    # beam endpoint in open space ~ (0, 1.0): nearest obstacle is... compute
    # from the map's own LUT for the golden value
    scan2 = _mk_scan([1.0], [math.pi / 2])
    ij = box_map.world_to_map(jnp.array([0.0, 1.0]))
    d = float(box_map.distance_at(ij))
    pz2 = 0.95 * math.exp(-(d * d) / (2 * 0.2**2)) + 0.01
    p2, _ = _apply(box_map, params, scan2, [[0.0, 0.0, 0.0]], "likelihood_field")
    np.testing.assert_allclose(float(p2[0]), 1.0 + pz2**3, rtol=1e-5)


def test_lf_skips_max_range_and_nan(box_map):
    params = PlanarScanParams()
    scan = _mk_scan([5.0, float("nan"), 1.0], [0.0, 0.1, 0.0])
    p, _ = _apply(box_map, params, scan, [[0.0, 0.0, 0.0]], "likelihood_field")
    scan_only = _mk_scan([1.0], [0.0])
    p_only, _ = _apply(box_map, params, scan_only, [[0.0, 0.0, 0.0]], "likelihood_field")
    np.testing.assert_allclose(float(p[0]), float(p_only[0]), rtol=1e-6)


def test_lf_off_map_penalized_as_max_distance(box_map):
    """Endpoint off the map reads max_distance (planar_scanner.cpp:295-300)."""
    params = PlanarScanParams()
    scan = _mk_scan([4.0], [0.0])  # endpoint at (4, 0) — off the [-2,2] map
    p, _ = _apply(box_map, params, scan, [[0.0, 0.0, 0.0]], "likelihood_field")
    zmax = box_map.max_distance_to_object
    pz = 0.95 * math.exp(-(zmax**2) / (2 * 0.2**2)) + 0.01
    np.testing.assert_allclose(float(p[0]), 1.0 + pz**3, rtol=1e-5)


def test_scanner_mount_pose(box_map):
    """The scanner extrinsic shifts beam origins via coordAdd
    (planar_scanner.cpp:189)."""
    params = PlanarScanParams(scanner_pose=jnp.array([0.5, 0.0, 0.0]))
    scan = _mk_scan([0.5], [0.0])
    # particle at origin; scanner at (0.5, 0); endpoint (1.0, 0) -> pillar hit
    p, _ = _apply(box_map, params, scan, [[0.0, 0.0, 0.0]], "likelihood_field")
    pz = 0.95 + 0.01
    np.testing.assert_allclose(float(p[0]), 1.0 + pz**3, rtol=1e-5)


def test_beam_model_golden(box_map):
    """Beam model mixture against hand-computed raycast distances."""
    params = PlanarScanParams()
    # facing +x from origin: wall of pillar at x = 0.8..1.2 -> first
    # occupied cell at world x=0.85ish; compute via the map itself
    from badger_amcl.sensors.raycast import calc_range

    map_range = float(calc_range(box_map, jnp.array(0.0), jnp.array(0.0), jnp.array(0.0), 5.0))
    obs = 1.0
    scan = _mk_scan([obs], [0.0])
    p, _ = _apply(box_map, params, scan, [[0.0, 0.0, 0.0]], "beam")
    z = obs - map_range
    pz = 0.95 * math.exp(-(z * z) / (2 * 0.2**2))
    if z < 0:
        pz += 0.1 * 0.1 * math.exp(-0.1 * obs)
    pz += 0.05 / 5.0  # obs < range_max
    np.testing.assert_allclose(float(p[0]), 1.0 + pz**3, rtol=1e-4)


def test_beam_model_max_range_reading(box_map):
    params = PlanarScanParams()
    # beam pointing +x with obs == range_max: z_max term, no z_rand term
    from badger_amcl.sensors.raycast import calc_range

    map_range = float(calc_range(box_map, jnp.array(0.0), jnp.array(0.0), jnp.array(0.0), 5.0))
    scan = _mk_scan([5.0], [0.0], range_max=5.0)
    p, _ = _apply(box_map, params, scan, [[0.0, 0.0, 0.0]], "beam")
    z = 5.0 - map_range
    pz = 0.95 * math.exp(-(z * z) / (2 * 0.2**2)) + 0.05
    np.testing.assert_allclose(float(p[0]), 1.0 + pz**3, rtol=1e-4)


def test_gompertz_function():
    """applyGompertz (planar_scanner.cpp:540-550) and the key points the
    reference logs at node_2d.cpp:181-187."""
    params = PlanarScanParams(
        gompertz_a=jnp.float32(1.0), gompertz_b=jnp.float32(4.3),
        gompertz_c=jnp.float32(8.0), input_shift=jnp.float32(-0.2),
        input_scale=jnp.float32(1.0), output_shift=jnp.float32(0.02),
    )
    def ref_g(p):
        p = p * 1.0 + (-0.2)
        return 1.0 * math.exp(-4.3 * math.exp(-8.0 * p)) + 0.02
    for x in (0.05, 0.05 + 0.95 * 0.25, 0.05 + 0.95 * 0.5, 1.0):
        np.testing.assert_allclose(
            float(apply_gompertz(params, jnp.float32(x))), ref_g(x), rtol=1e-5
        )


def test_lf_gompertz_mean_and_novalid(box_map):
    params = PlanarScanParams()
    scan = _mk_scan([1.0, 1.0], [0.0, 0.0])
    p, _ = _apply(box_map, params, scan, [[0.0, 0.0, 0.0]], "likelihood_field_gompertz")
    pz = 0.95 + 0.05  # d=0 at pillar; z_rand added raw in gompertz variant
    want = float(apply_gompertz(PlanarScanParams(), jnp.float32(pz)))
    np.testing.assert_allclose(float(p[0]), want, rtol=1e-5)
    # all-invalid scan -> p = 1.0 (weight unchanged)
    scan2 = _mk_scan([5.0, 5.0], [0.0, 0.0])
    p2, _ = _apply(box_map, params, scan2, [[0.0, 0.0, 0.0]], "likelihood_field_gompertz")
    np.testing.assert_allclose(float(p2[0]), 1.0)


def test_lf_prob_log_product(box_map):
    params = PlanarScanParams()
    scan = _mk_scan([1.0, 2.0], [0.0, math.pi / 2])
    p_prob, _ = _apply(box_map, params, scan, [[0.0, 0.0, 0.0]], "likelihood_field_prob")
    # compute expected: product of pz over the two beams
    def pz_of(range_, ang):
        hx, hy = range_ * math.cos(ang), range_ * math.sin(ang)
        d = float(box_map.distance_at(box_map.world_to_map(jnp.array([hx, hy]))))
        return 0.95 * math.exp(-(d * d) / (2 * 0.2**2)) + 0.05 / 5.0
    want = pz_of(1.0, 0.0) * pz_of(2.0, math.pi / 2)
    np.testing.assert_allclose(float(p_prob[0]), want, rtol=1e-4)


def test_beamskip_masks_disagreeing_beams(box_map):
    """With do_beamskip and a converged set, beams that disagree with the map
    for most particles are excluded (planar_scanner.cpp:352-533)."""
    params = PlanarScanParams(
        beam_skip_distance=jnp.float32(0.2),
        beam_skip_threshold=jnp.float32(0.5),
        beam_skip_error_threshold=jnp.float32(0.9),
    )
    # 100 particles at the origin; beam 0 agrees (pillar hit), beam 1 points
    # at open space (d large) -> disagrees -> skipped
    poses = np.tile([0.0, 0.0, 0.0], (100, 1))
    scan = _mk_scan([1.0, 1.0], [0.0, math.pi / 2])
    p_skip, _ = _apply(
        box_map, params, scan, poses, "likelihood_field_prob",
        converged=True, do_beamskip=True,
    )
    # expected: only beam 0 integrated
    def pz_of(range_, ang):
        hx, hy = range_ * math.cos(ang), range_ * math.sin(ang)
        d = float(box_map.distance_at(box_map.world_to_map(jnp.array([hx, hy]))))
        return 0.95 * math.exp(-(d * d) / (2 * 0.2**2)) + 0.05 / 5.0
    np.testing.assert_allclose(float(p_skip[0]), pz_of(1.0, 0.0), rtol=1e-4)
    # not converged -> beamskip disabled, both beams integrate
    p_noskip, _ = _apply(
        box_map, params, scan, poses, "likelihood_field_prob",
        converged=False, do_beamskip=True,
    )
    want_all = pz_of(1.0, 0.0) * pz_of(1.0, math.pi / 2)
    np.testing.assert_allclose(float(p_noskip[0]), want_all, rtol=1e-4)


def test_map_factors(box_map):
    params = PlanarScanParams(
        off_map_factor=jnp.float32(0.1),
        non_free_space_factor=jnp.float32(0.3),
        non_free_space_radius=jnp.float32(0.4),
    )
    poses = jnp.array(
        [
            [10.0, 0.0, 0.0],   # off map -> 0.1
            [1.0, 0.0, 0.0],    # inside pillar (occupied) -> 0.3
            [0.0, 0.0, 0.0],    # free, far from anything? d at origin
            [0.7, 0.0, 0.0],    # free but near pillar -> interpolated
        ],
        jnp.float32,
    )
    f = np.asarray(map_factors(box_map, params, poses))
    np.testing.assert_allclose(f[0], 0.1, rtol=1e-6)
    np.testing.assert_allclose(f[1], 0.3, rtol=1e-6)
    d2 = float(box_map.distance_at(box_map.world_to_map(poses[2, :2])))
    want2 = 0.3 + (d2 / 0.4) * 0.7 if d2 < 0.4 else 1.0
    np.testing.assert_allclose(f[2], want2, rtol=1e-5)
    d3 = float(box_map.distance_at(box_map.world_to_map(poses[3, :2])))
    assert d3 < 0.4
    np.testing.assert_allclose(f[3], 0.3 + (d3 / 0.4) * 0.7, rtol=1e-5)


def test_map_factors_windowed_matches_classic(box_map):
    """The tight-cloud one-hot window path must agree bit-for-bit with the
    per-particle gather path (sensors/planar.py map_factors), baked or not."""
    import jax

    from badger_amcl.sensors.planar import bake_factor_texture

    params = PlanarScanParams(
        off_map_factor=jnp.float32(0.1),
        non_free_space_factor=jnp.float32(0.3),
        non_free_space_radius=jnp.float32(0.4),
    )
    rng = np.random.default_rng(7)
    # tight cloud near the pillar: cells span << (FWIN_R, FWIN_C)
    poses = jnp.asarray(
        np.stack([rng.uniform(0.3, 0.9, 256), rng.uniform(-0.3, 0.3, 256),
                  rng.uniform(-3, 3, 256)], axis=1), jnp.float32)

    f_win = np.asarray(map_factors(box_map, params, poses))

    # force the classic path by spreading one particle far away (window
    # cannot fit) and compare the shared prefix
    poses_wide = jnp.concatenate(
        [poses, jnp.array([[-4.5, -4.5, 0.0]], jnp.float32)])
    f_classic = np.asarray(map_factors(box_map, params, poses_wide))[:-1]
    np.testing.assert_array_equal(f_win, f_classic)

    # baked texture path: identical values
    baked = bake_factor_texture(box_map, params)
    assert baked.factor_tex is not None
    f_baked = np.asarray(map_factors(baked, params, poses))
    np.testing.assert_array_equal(f_win, f_baked)

    # stale-params fingerprint: a different radius must NOT ride the bake
    params2 = params.replace(non_free_space_radius=jnp.float32(0.8))
    f2 = np.asarray(map_factors(baked, params2, poses))
    f2_ref = np.asarray(map_factors(box_map, params2, poses))
    np.testing.assert_array_equal(f2, f2_ref)

    # under jit too (cond trace)
    f_jit = np.asarray(jax.jit(map_factors)(baked, params, poses))
    np.testing.assert_array_equal(f_jit, f_win)
