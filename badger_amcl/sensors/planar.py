"""Planar (2D laser) measurement models.

All four models of the reference's `PlanarScanner`
(src/amcl/sensors/planar_scanner.cpp) as batched `(N, B)` array programs:

- BEAM                      <- calcBeamModel (planar_scanner.cpp:168-234)
- LIKELIHOOD_FIELD          <- calcLikelihoodFieldModel (:236-323)
- LIKELIHOOD_FIELD_PROB     <- calcLikelihoodFieldModelProb incl. beam
                               skipping (:325-533)
- LIKELIHOOD_FIELD_GOMPERTZ <- calcLikelihoodFieldModelGompertz (:540-640)

plus the off-map / non-free-space weight correction
(recalcWeight, :642-682) and the scanner-mount composition
(coordAdd, :693-701).

The reference's doubly nested particle x beam loops (hot loop #2,
SURVEY.md §3.1) become broadcasted trig + one batched gather from the
distance-field texture; the beam model calls the vectorized Bresenham bundle
in sensors/raycast.py. Beam skipping's per-particle temp buffers
(planar_scanner.cpp:367-395) collapse into reductions over the (N, B) pz
matrix that is materialized anyway.

Beam decimation (step subsampling to max_beams) is *host-side scan prep* in
this design (node/scan_prep.py) so the kernels see static beam counts.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from badger_amcl.maps.occupancy_2d import CellState, OccupancyMap2D
from badger_amcl.sensors import raycast
from badger_amcl.utils.angles import normalize_angle
from badger_amcl.utils.pytree import pytree_dataclass


@pytree_dataclass
class PlanarScanParams:
    """Measurement-model parameters (setModel* setters,
    planar_scanner.cpp:55-121). All leaves are dynamic so live reconfigure
    does not recompile; the model *type* is a static argument to
    `planar_likelihood`."""

    z_hit: jnp.ndarray = 0.95
    z_short: jnp.ndarray = 0.1
    z_max: jnp.ndarray = 0.05
    z_rand: jnp.ndarray = 0.05
    sigma_hit: jnp.ndarray = 0.2
    lambda_short: jnp.ndarray = 0.1
    # Gompertz squashing (setModelLikelihoodFieldGompertz, :94-113)
    gompertz_a: jnp.ndarray = 1.0
    gompertz_b: jnp.ndarray = 1.0
    gompertz_c: jnp.ndarray = 1.0
    input_shift: jnp.ndarray = 0.0
    input_scale: jnp.ndarray = 1.0
    output_shift: jnp.ndarray = 0.0
    # map factors (setMapFactors, :115-121)
    off_map_factor: jnp.ndarray = 1.0
    non_free_space_factor: jnp.ndarray = 1.0
    non_free_space_radius: jnp.ndarray = 0.0
    # beam skipping (setModelLikelihoodFieldProb, :77-92)
    beam_skip_distance: jnp.ndarray = 0.5
    beam_skip_threshold: jnp.ndarray = 0.3
    beam_skip_error_threshold: jnp.ndarray = 0.9
    # scanner mount pose in the base frame (setPlanarScannerPose, :535-538)
    scanner_pose: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.zeros((3,), jnp.float32)
    )


@pytree_dataclass
class PlanarScan:
    """Decimated scan (PlanarData, planar_scanner.h): ranges/angles (B,) in
    the base frame, range_max scalar. Padding entries use range == range_max
    (ignored by every LF-family model; the beam model sees them as max-range
    readings, which is exactly what the node's range clamping produces)."""

    ranges: jnp.ndarray
    angles: jnp.ndarray
    range_max: jnp.ndarray


def coord_add(a, b):
    """Compose local pose a onto global pose(s) b (coordAdd,
    planar_scanner.cpp:693-701). b: (..., 3)."""
    bx, by, bth = b[..., 0], b[..., 1], b[..., 2]
    c, s = jnp.cos(bth), jnp.sin(bth)
    x = bx + a[0] * c - a[1] * s
    y = by + a[0] * s + a[1] * c
    th = normalize_angle(bth + a[2])
    return jnp.stack([x, y, th], axis=-1)


def apply_gompertz(params: PlanarScanParams, p):
    """applyGompertz (planar_scanner.cpp:540-550)."""
    p = p * params.input_scale + params.input_shift
    p = params.gompertz_a * jnp.exp(-params.gompertz_b * jnp.exp(-params.gompertz_c * p))
    return p + params.output_shift


def beam_endpoint_distances(omap, scan, spose):
    """Common LF-family front half: beam endpoints -> map cells -> distance
    gather, computed directly in (B, N) orientation. `spose` is the scanner
    pose per particle (coord_add of the mount onto the particle poses).
    Returns (z (B, N) meters, valid_beam (B,) mask)."""
    valid = (scan.ranges < scan.range_max) & ~jnp.isnan(scan.ranges)
    ranges = scan.ranges[:, None]
    angles = scan.angles[:, None]
    th = spose[None, :, 2] + angles
    hx = spose[None, :, 0] + ranges * jnp.cos(th)
    hy = spose[None, :, 1] + ranges * jnp.sin(th)
    ij = omap.world_to_map(jnp.stack([hx, hy], axis=-1))
    zt = omap.distance_at(ij)  # off-map -> max_distance (planar_scanner.cpp:295-300)
    return zt, valid


def _lf_model(omap, params, scan, spose):
    """calcLikelihoodFieldModel (planar_scanner.cpp:236-323):
    pz = z_hit exp(-z^2/2s^2) + z_rand/range_max; p = 1 + sum pz^3 over
    valid beams (max-range and NaN beams skipped)."""
    zt, valid = beam_endpoint_distances(omap, scan, spose)
    denom = 2.0 * params.sigma_hit * params.sigma_hit
    pz = params.z_hit * jnp.exp(-(zt * zt) / denom) \
        + params.z_rand / scan.range_max
    return 1.0 + jnp.sum(jnp.where(valid[:, None], pz * pz * pz, 0.0), axis=0)


def _lf_gompertz_model(omap, params, scan, spose):
    """calcLikelihoodFieldModelGompertz (planar_scanner.cpp:552-640):
    per-particle *mean* pz (note z_rand added raw, no /range_max,
    :597) through the Gompertz squash; no valid beams -> p = 1."""
    zt, valid = beam_endpoint_distances(omap, scan, spose)
    denom = 2.0 * params.sigma_hit * params.sigma_hit
    pz = params.z_hit * jnp.exp(-(zt * zt) / denom) + params.z_rand
    count = jnp.sum(valid)
    sum_pz = jnp.sum(jnp.where(valid[:, None], pz, 0.0), axis=0)
    p = apply_gompertz(params, sum_pz / jnp.maximum(count, 1))
    return jnp.where(count > 0, p, 1.0)


def _lf_prob_model(omap, params, scan, spose, active, n_active, converged,
                   do_beamskip, return_log=False):
    """calcLikelihoodFieldModelProb (planar_scanner.cpp:325-533), log-space
    product over valid beams, optional beam skipping.

    return_log (static): return LOG p instead of p — the log-space-resident
    pipeline (pf.filter.sensor_update_log) that keeps the prob model usable
    at high beam counts, where exp(sum of ~720 log pz) underflows f32 for
    every particle and the filter would uniform-reset forever. The default
    exp path stays reference-exact.

    Beam skipping (static `do_beamskip`; additionally gated on filter
    convergence, :361-364): beams for which fewer than beam_skip_threshold of
    the particles see the map within beam_skip_distance are masked for
    everyone; if too many beams get masked (>= max_beams *
    error_threshold), integrate all beams instead (:482-530). Invalid
    (max-range/NaN) beams carry pz = 0 in the temp matrix exactly like the
    reference's cleared temp buffers, so the error fallback reproduces its
    zero-weight collapse."""
    zt, valid = beam_endpoint_distances(omap, scan, spose)
    denom = 2.0 * params.sigma_hit * params.sigma_hit
    pz = params.z_hit * jnp.exp(-(zt * zt) / denom) + params.z_rand / scan.range_max
    logpz = jnp.log(pz)
    if not do_beamskip:
        log_p = jnp.sum(jnp.where(valid[:, None], logpz, 0.0), axis=0)
        return log_p if return_log else jnp.exp(log_p)

    b = scan.ranges.shape[0]
    # in-map test for the obs_count increment (:441-453): only beams whose
    # endpoint lands on the map count toward agreement
    ranges = scan.ranges[:, None]
    th = spose[None, :, 2] + scan.angles[:, None]
    hx = spose[None, :, 0] + ranges * jnp.cos(th)
    hy = spose[None, :, 1] + ranges * jnp.sin(th)
    in_map = omap.is_valid(omap.world_to_map(jnp.stack([hx, hy], axis=-1)))
    agrees = in_map & (zt < params.beam_skip_distance) & valid[:, None] & active[None, :]
    obs_count = jnp.sum(agrees, axis=1).astype(jnp.float32)
    obs_mask = obs_count / jnp.maximum(n_active.astype(jnp.float32), 1.0) > (
        params.beam_skip_threshold
    )
    skipped = jnp.sum(~obs_mask)
    error = skipped >= b * params.beam_skip_error_threshold
    # second pass (:512-529); invalid beams have temp pz == 0 -> log 0 = -inf
    pz_temp = jnp.where(valid[:, None], pz, 0.0)
    use_beam = error | obs_mask[:, None]
    log_p = jnp.sum(jnp.where(use_beam, jnp.log(pz_temp), 0.0), axis=0)
    log_p_all = jnp.where(converged, log_p, jnp.sum(jnp.where(valid[:, None], logpz, 0.0), axis=0))
    return log_p_all if return_log else jnp.exp(log_p_all)


def _beam_model(omap, params, scan, spose):
    """calcBeamModel (planar_scanner.cpp:168-234): per-beam exact Bresenham
    map raycast (sensors/raycast.py) plus the 4-part hit/short/max/rand
    mixture; p = 1 + sum pz^3 over *all* beams (the beam model has no
    NaN/max-range skip)."""
    map_range = raycast.calc_range(
        omap,
        spose[:, 0:1],
        spose[:, 1:2],
        spose[:, 2:3] + scan.angles[None, :],
        scan.range_max,
    )
    obs = scan.ranges[None, :]
    zerr = obs - map_range
    denom = 2.0 * params.sigma_hit * params.sigma_hit
    pz = params.z_hit * jnp.exp(-(zerr * zerr) / denom)
    pz += jnp.where(
        zerr < 0, params.z_short * params.lambda_short * jnp.exp(-params.lambda_short * obs), 0.0
    )
    pz += jnp.where(obs == scan.range_max, params.z_max, 0.0)
    pz += jnp.where(obs < scan.range_max, params.z_rand / scan.range_max, 0.0)
    return 1.0 + jnp.sum(pz * pz * pz, axis=1)


def factor_fingerprint(params: PlanarScanParams):
    """Everything the baked factor texture embeds (off_map_factor is applied
    per-particle outside the texture). None when traced (can't fingerprint)."""
    try:
        return (float(params.non_free_space_factor),
                float(params.non_free_space_radius))
    except Exception:
        return None


def _factor_texture(omap: OccupancyMap2D, params: PlanarScanParams):
    """The recalcWeight per-cell factor texture: cell state and distance
    fused elementwise so each particle costs ONE read (not two). Uses the
    baked copy (bake_factor_texture) when its fingerprint matches."""
    want = factor_fingerprint(params)
    if omap.factor_tex is not None and want is not None \
            and omap.factor_key == want:
        return omap.factor_tex
    nf = params.non_free_space_factor
    interp = jnp.where(
        omap.distances < params.non_free_space_radius,
        nf + (omap.distances / jnp.maximum(params.non_free_space_radius, 1e-30))
        * (1.0 - nf),
        1.0,
    )
    return jnp.where(
        omap.cells != jnp.int8(CellState.FREE), nf, interp
    ).astype(jnp.float32)


def bake_factor_texture(omap: OccupancyMap2D,
                        params: PlanarScanParams) -> OccupancyMap2D:
    """Pre-bake the recalcWeight factor texture — one-shot per (map, params),
    like the reference's distance-LUT bake. Used only where the params are
    concrete (a traced params tree cannot be fingerprinted and rebuilds the
    texture per call)."""
    if omap.distances is None:
        return dataclasses.replace(omap, factor_tex=None, factor_key=None)
    key = factor_fingerprint(params)
    if key is None:
        return dataclasses.replace(omap, factor_tex=None, factor_key=None)
    tex = _factor_texture(
        dataclasses.replace(omap, factor_tex=None, factor_key=None), params)
    return dataclasses.replace(omap, factor_tex=tex, factor_key=key)


# factor window for the tight-cloud one-hot read (map_factors fast path)
FWIN_R = 32
FWIN_C = 128


def map_factors(omap: OccupancyMap2D, params: PlanarScanParams, poses):
    """recalcWeight (planar_scanner.cpp:642-682): multiplicative penalty per
    particle — off-map, non-free-space, or radius-interpolated.

    Two paths, identical results:
    - tight clouds (all particle cells inside one FWIN_R x FWIN_C window —
      every tracking step): dynamic-slice the window and read it with a
      one-hot row matmul + column pick instead of an M-sized gather
      (whether this beats the plain gather on the GPU is an open
      measurement, ROADMAP.md Queue 1);
    - otherwise: the classic per-particle texture gather.
    The one-hot matmul runs at Precision.HIGHEST (full float32, never TF32
    or bf16) so both paths agree bit-for-bit."""
    factor_tex = _factor_texture(omap, params)
    ij = omap.world_to_map(poses[:, :2])
    valid = omap.is_valid(ij)
    ci = jnp.clip(ij[..., 0], 0, omap.size_x - 1)
    cj = jnp.clip(ij[..., 1], 0, omap.size_y - 1)

    def classic(_):
        f = jnp.take(factor_tex.reshape(-1), cj * omap.size_x + ci)
        return jnp.where(valid, f, params.off_map_factor)

    if (poses.ndim != 2 or omap.size_y < FWIN_R or omap.size_x < FWIN_C):
        return classic(None)

    i0 = jnp.clip(jnp.min(ci), 0, omap.size_x - FWIN_C)
    j0 = jnp.clip(jnp.min(cj), 0, omap.size_y - FWIN_R)
    fits = (jnp.max(ci) - i0 < FWIN_C) & (jnp.max(cj) - j0 < FWIN_R)

    def windowed(_):
        win = jax.lax.dynamic_slice(factor_tex, (j0, i0), (FWIN_R, FWIN_C))

        dj = cj - j0
        di = ci - i0
        ohr = (dj[:, None] == jnp.arange(FWIN_R, dtype=dj.dtype)[None, :])
        rows = jax.lax.dot_general(
            ohr.astype(jnp.float32), win,
            dimension_numbers=(((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )  # (M, FWIN_C)
        ohc = di[:, None] == jnp.arange(FWIN_C, dtype=di.dtype)[None, :]
        f = jnp.sum(jnp.where(ohc, rows, 0.0), axis=1)
        return jnp.where(valid, f, params.off_map_factor)

    return jax.lax.cond(fits, windowed, classic, operand=None)


PLANAR_MODELS = ("beam", "likelihood_field", "likelihood_field_prob",
                 "likelihood_field_gompertz")


def planar_likelihood(
    omap: OccupancyMap2D,
    params: PlanarScanParams,
    scan: PlanarScan,
    poses: jnp.ndarray,
    active: jnp.ndarray,
    n_active: jnp.ndarray,
    model: str,
    converged=False,
    do_beamskip: bool = False,
    prob_log_space: bool = False,
):
    """applyModelToSampleSet (planar_scanner.cpp:141-164): returns
    (p_model (N,), map_factor (N,)) to feed pf.sensor_update. `model` and
    `do_beamskip` are static; an unknown model raises.
    prob_log_space (static, likelihood_field_prob only): return LOG p for
    the log-space-resident weight pipeline (pf.filter.sensor_update_log) —
    the variant that holds 720 beams without f32 underflow."""
    spose = coord_add(params.scanner_pose, poses)
    if model == "beam":
        p = _beam_model(omap, params, scan, spose)
    elif model == "likelihood_field":
        p = _lf_model(omap, params, scan, spose)
    elif model == "likelihood_field_prob":
        p = _lf_prob_model(
            omap, params, scan, spose, active, n_active, converged, do_beamskip,
            return_log=prob_log_space,
        )
    elif model == "likelihood_field_gompertz":
        p = _lf_gompertz_model(omap, params, scan, spose)
    else:
        raise ValueError(f"unknown planar model {model!r}")
    return p, map_factors(omap, params, poses)
