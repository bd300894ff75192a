"""Log-space-resident weight pipeline for likelihood_field_prob
(pf.filter.sensor_update_log + resample(log_averages=True)).

The prob model multiplies up to B per-beam probabilities
(planar_scanner.cpp:325-533); in f32 every particle's product underflows to
0 past ~60 beams, so the filter uniform-resets forever at 720 beams.
The log pipeline keeps log weights through normalization and the recovery
averages in log domain. The default exp path is untouched (bit-equal parity
rows preserved); these tests prove the log path against an f64 CPU oracle
at 720 beams and its equivalence to the linear path where both are finite.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from badger_amcl.pf import filter as pf_filter
from badger_amcl.pf.types import PFParams


def _mk_state(m, seed=0):
    params = PFParams(min_samples=32, max_samples=m)
    rng = np.random.default_rng(seed)
    poses = np.stack([
        rng.uniform(-4, 4, m), rng.uniform(-4, 4, m),
        rng.uniform(-np.pi, np.pi, m)], axis=1).astype(np.float32)
    state = pf_filter.init_with_poses(
        params, jax.random.PRNGKey(seed), jnp.asarray(poses))
    return params, state


def test_log_update_matches_f64_oracle_at_720_beams():
    """720-beam log p values (way below f32's exp range): normalized
    weights must match the f64 linear-domain oracle; the default linear
    path must collapse to uniform (the documented underflow)."""
    m, b = 2048, 720
    params, state = _mk_state(m)
    rng = np.random.default_rng(1)
    # per-beam log pz ~ log(0.3..0.95): sums ~ -700 .. -40*b
    logpz = np.log(rng.uniform(0.3, 0.95, (m, b)))
    logp = logpz.sum(axis=1)  # (m,) ~ [-600, -400]
    assert logp.max() < -100  # exp() underflows f32 everywhere

    state = pf_filter.init_log_averages(state)
    out = pf_filter.sensor_update_log(state, jnp.asarray(logp, jnp.float32))
    w = np.asarray(out.weights, np.float64)

    # f64 oracle
    lw = logp - logp.max()
    ww = np.exp(lw)
    want = ww / ww.sum()
    np.testing.assert_allclose(w, want, rtol=5e-4, atol=1e-9)

    # log-domain w_avg = logsumexp(log w_prev + logp) - log n
    lse = logp.max() + np.log(np.exp(logp - logp.max()).sum()) - np.log(m)
    want_avg = lse - np.log(m)
    assert np.isclose(float(out.w_slow), want_avg, rtol=1e-4)
    assert np.isclose(float(out.w_fast), want_avg, rtol=1e-4)

    # the DEFAULT linear path at these magnitudes: total 0 -> uniform reset
    out_lin = pf_filter.sensor_update(
        state.replace(w_slow=jnp.float32(0), w_fast=jnp.float32(0)),
        jnp.exp(jnp.asarray(logp, jnp.float32)), None)
    np.testing.assert_allclose(np.asarray(out_lin.weights), 1.0 / m)


def test_log_vs_linear_equivalence_in_overlap_regime():
    """Where the linear path is finite (small log magnitudes), both paths
    must agree: weights, w_slow/w_fast (log vs linear domain), and the
    resample w_diff/injection behavior."""
    m = 1024
    params, state0 = _mk_state(m, seed=2)
    rng = np.random.default_rng(3)
    logp = rng.uniform(-3.0, 0.0, m)
    p = np.exp(logp).astype(np.float32)

    lin = state0.replace(w_slow=jnp.float32(0.02), w_fast=jnp.float32(0.01))
    lg = state0.replace(
        w_slow=jnp.float32(np.log(0.02)), w_fast=jnp.float32(np.log(0.01)))

    out_lin = pf_filter.sensor_update(lin, jnp.asarray(p), None)
    out_log = pf_filter.sensor_update_log(lg, jnp.asarray(logp, jnp.float32))
    np.testing.assert_allclose(
        np.asarray(out_log.weights), np.asarray(out_lin.weights),
        rtol=2e-4, atol=1e-9)
    assert np.isclose(
        float(jnp.exp(out_log.w_slow)), float(out_lin.w_slow), rtol=1e-4)
    assert np.isclose(
        float(jnp.exp(out_log.w_fast)), float(out_lin.w_fast), rtol=1e-4)

    # resample: same w_diff (so the same number of injected particles in
    # distribution) and log-domain sentinel reset
    pool = jnp.full((m, 3), -555.0, jnp.float32)
    r_lin = pf_filter.resample(out_lin, params, pool)
    r_log = pf_filter.resample(out_log, params, pool, log_averages=True)
    inj_lin = float((np.asarray(r_lin.poses)[:, 0] == -555.0).mean())
    inj_log = float((np.asarray(r_log.poses)[:, 0] == -555.0).mean())
    assert abs(inj_lin - inj_log) < 0.05, (inj_lin, inj_log)
    # both reset their averages to their own domain's sentinel
    assert float(r_lin.w_slow) == 0.0
    assert float(r_log.w_slow) == float(pf_filter.LOG_UNINIT)


def test_full_model_log_path_720_beams_vs_f64_oracle():
    """End-to-end: planar_likelihood(prob, prob_log_space=True) at 720
    beams through sensor_update_log vs an f64 numpy oracle of the same
    model (distance field gathers + log mixture)."""
    from badger_amcl.maps import CellState, OccupancyMap2D
    from badger_amcl.sensors.planar import (
        PlanarScan, PlanarScanParams, planar_likelihood)

    rng = np.random.default_rng(5)
    n = 320
    cells = np.full((n, n), int(CellState.FREE), np.int8)
    cells[0:2, :] = cells[-2:, :] = int(CellState.OCCUPIED)
    cells[:, 0:2] = cells[:, -2:] = int(CellState.OCCUPIED)
    for _ in range(12):
        cx, cy = rng.integers(16, n - 24, 2)
        cells[cy:cy + 6, cx:cx + 6] = int(CellState.OCCUPIED)
    omap = OccupancyMap2D.from_cells(cells, 0.05).with_distance_field(2.0)

    m, b = 1500, 720
    poses = np.stack([
        rng.uniform(-6, 6, m), rng.uniform(-6, 6, m),
        rng.uniform(-np.pi, np.pi, m)], axis=1).astype(np.float32)
    angles = np.linspace(-2.2, 2.2, b).astype(np.float32)
    ranges = np.clip(2.0 + np.sin(angles * 5.0), 0.3, 5.5).astype(np.float32)
    scan = PlanarScan(ranges=jnp.asarray(ranges), angles=jnp.asarray(angles),
                      range_max=jnp.float32(6.0))
    params = PlanarScanParams()

    logp, mf = planar_likelihood(
        omap, params, scan, jnp.asarray(poses), jnp.ones((m,), bool),
        jnp.int32(m), "likelihood_field_prob", prob_log_space=True)
    pf_params = PFParams(min_samples=32, max_samples=m)
    st = pf_filter.init_with_poses(
        pf_params, jax.random.PRNGKey(0), jnp.asarray(poses))
    st = pf_filter.init_log_averages(st)
    out = pf_filter.sensor_update_log(st, logp, mf)
    w = np.asarray(out.weights, np.float64)
    assert np.isfinite(w).all() and w.sum() > 0.99

    # f64 oracle over f32 endpoint geometry: the log-sum/normalization/
    # factor pipeline is checked in f64, while endpoint CELLS follow the
    # framework's own f32 trig — at 720 beams a single one-cell flip
    # rescales a particle's weight by e^+-3, so an f64-trig oracle would
    # disagree astronomically for reasons that are not the pipeline's.
    th = (poses[:, 2:3] + angles[None, :]).astype(np.float32)
    hx = (poses[:, 0:1] + ranges[None, :] * np.cos(th)).astype(np.float32)
    hy = (poses[:, 1:2] + ranges[None, :] * np.sin(th)).astype(np.float32)
    ij = np.asarray(omap.world_to_map(jnp.stack(
        [jnp.asarray(hx), jnp.asarray(hy)], axis=-1)))
    dist = np.asarray(omap.distances, np.float64)
    ii = np.clip(ij[..., 0], 0, omap.size_x - 1)
    jj = np.clip(ij[..., 1], 0, omap.size_y - 1)
    inmap = ((ij[..., 0] >= 0) & (ij[..., 0] < omap.size_x)
             & (ij[..., 1] >= 0) & (ij[..., 1] < omap.size_y))
    z = np.where(inmap, dist[jj, ii], float(omap.max_distance_to_object))
    valid = (ranges < 6.0) & ~np.isnan(ranges)
    pz = (float(params.z_hit)
          * np.exp(-(z ** 2) / (2 * float(params.sigma_hit) ** 2))
          + float(params.z_rand) / 6.0)
    lp = (np.log(pz) * valid[None, :]).sum(axis=1)
    mf_np = np.asarray(mf, np.float64)
    lw = lp + np.log(mf_np)
    lw -= lw.max()
    want = np.exp(lw)
    want /= want.sum()
    # residual 1-ulp cos/sin differences (XLA vs numpy) can still flip the
    # odd cell: compare robust statistics — top particle agreement and
    # total-variation distance
    assert int(np.argmax(w)) == int(np.argmax(want))
    assert np.abs(w - want).sum() < 0.05  # total variation distance
    idx = np.argsort(want)[::-1][:5]
    np.testing.assert_allclose(w[idx], want[idx], rtol=0.25, atol=1e-6)


def test_node_log_space_knob_tracks(tmp_path):
    """Node-level: laser_likelihood_log_space + prob model at a beam count
    far past the linear path's underflow still TRACKS in the sim (the
    linear path would uniform-reset every scan)."""
    import math

    from badger_amcl.config import AMCLConfig
    from badger_amcl.node import make_node
    from badger_amcl.sim import Sim2D, make_room_grid

    cfg = AMCLConfig(
        laser_model_type="likelihood_field_prob",
        laser_likelihood_log_space=True,
        laser_max_beams=240, min_particles=300, max_particles=1200,
        update_min_d=0.05, update_min_a=0.05, resample_interval=2,
        save_pose=False, do_beamskip=False,
    )
    grid = make_room_grid(n=160, resolution=0.05, n_pillars=6)
    sim = Sim2D(grid, start_pose=(0.5, -0.5, 0.4), n_beams=240,
                base_frame=cfg.base_frame_id, seed=3)
    node = make_node(cfg, tf_buffer=sim.tf)
    node.init_pose = np.array([0.5, -0.5, 0.4])
    node.init_cov = np.array([0.1, 0.1, 0.05])
    node.map_msg_received(grid)
    assert float(node.state.w_slow) == float(pf_filter.LOG_UNINIT)
    pose_log = []
    node.subscribe_output("amcl_pose", pose_log.append)
    for _ in range(30):
        odom = sim.step(0.3, 0.2)
        node.integrate_odom(odom)
        node.scan_received(sim.make_scan())
        node.spin_once(sim.t)
    est = pose_log[-1].pose
    err = math.hypot(est[0] - sim.true_pose[0], est[1] - sim.true_pose[1])
    assert err < 0.3, err
    # weights are discriminative, not a perpetual uniform reset
    w = np.asarray(node.state.weights)
    assert w.max() > 2.0 / int(node.state.n_active)
