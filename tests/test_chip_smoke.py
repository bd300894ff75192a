"""chip_smoke.py on the CPU: its device check refuses the CPU before any
result is printed, its comparison helpers accept and refuse what they
should, and its phases run end to end at tiny widths with the CPU as both
device and reference (the rehearsal of a chip run)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from __graft_entry__ import _build_setup
from badger_amcl import reference
from badger_amcl.pf import filter as pf_filter


def test_four_cards_refuses_cpu_and_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "card_info", lambda: ["Some GPU, 700.00 W"] * 4)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.main(["--four-cards"])
    assert '"ok"' not in capsys.readouterr().out


def test_main_refuses_cpu_and_prints_no_result(monkeypatch, capsys):
    """JAX falling back to the CPU must fail the run with no JSON line,
    even where nvidia-smi answers."""
    monkeypatch.setattr(chip_smoke, "card_info", lambda: ["Some GPU, 700.00 W"])
    monkeypatch.setattr(chip_smoke, "cli_child", lambda: None)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.main([])
    out = capsys.readouterr().out
    assert "Some GPU, 700.00 W" in out
    assert '"ok"' not in out


def test_compare_lookups_sets_moved_particles_apart():
    a = np.zeros((4000, 10))
    b = a.copy()
    b[7, 3] = 0.05  # one endpoint moved one cell
    moved = chip_smoke.compare_lookups("t", a, b, max_step=0.0708)
    assert moved.sum() == 1 and moved[7]
    b[9, 1] = 0.2  # more than a cell step
    with pytest.raises(AssertionError, match="cell step"):
        chip_smoke.compare_lookups("t", a, b, max_step=0.0708)
    c = a.copy()
    c[:100, 0] = 0.05  # 0.25 % of pairs moved
    with pytest.raises(AssertionError, match="agree"):
        chip_smoke.compare_lookups("t", a, c, max_step=0.0708)
    r = a + 1.0
    assert not chip_smoke.compare_lookups("t", r, r * (1 + 2e-7), 0.07, rounding=1e-6).any()


def test_compare_values_tolerance_and_apart_share():
    ref = np.linspace(1.0, 2.0, 1000)
    moved = np.zeros(1000, bool)
    chip_smoke.compare_values("t", ref * (1 + 5e-6), ref, moved)
    with pytest.raises(AssertionError, match="relative difference"):
        chip_smoke.compare_values("t", ref * (1 + 5e-5), ref, moved)
    dev = ref.copy()
    dev[3] *= 1.1
    moved[3] = True  # set apart: not compared
    chip_smoke.compare_values("t", dev, ref, moved)
    moved[:20] = True
    with pytest.raises(AssertionError, match="moved lookup"):
        chip_smoke.compare_values("t", dev, ref, moved)


def test_mc_check_accepts_a_resample_and_refuses_a_shift():
    rng = np.random.default_rng(0)
    cloud = rng.normal(size=(20000, 3)) * [0.5, 0.3, 0.2]
    w = np.exp(-np.sum(cloud ** 2, axis=1))
    draws = cloud[rng.choice(len(cloud), 8000, p=w / w.sum())]
    chip_smoke.mc_check("t", draws, cloud, w)
    with pytest.raises(AssertionError, match="standard errors"):
        chip_smoke.mc_check("t", draws + [0.05, 0.0, 0.0], cloud, w)


def test_kld_recount_matches_the_filter():
    omap, params, state, scan, sp, pool = _build_setup(
        4000, 32, 128, pose_cov=(0.05, 0.05, 0.01), min_particles=100)
    p = jnp.ones((4000,), jnp.float32)
    out = pf_filter.resample(pf_filter.sensor_update(state, p, p), params, pool)
    n = reference.kld_sample_count(np.asarray(out.poses), params.min_samples,
                                   params.max_samples, params.pop_err, params.pop_z)
    assert params.min_samples < int(out.n_active) < params.max_samples
    assert n == int(out.n_active)


def test_warehouse_grid_layout():
    grid = chip_smoke.warehouse_grid(n=800)
    data = grid.data.reshape(800, 800)
    c = 400
    yy, xx = np.mgrid[:800, :800]
    near = (xx - c) ** 2 + (yy - c) ** 2 < (3.4 / grid.resolution) ** 2
    assert not data[near].any()  # the robot's disk is clear
    assert data[:4].all() and data[:, -4:].all()  # walls
    assert 0.05 < np.mean(data == 100) < 0.5


def test_phases_rehearse_on_cpu(capsys):
    cpu = jax.devices("cpu")[0]
    setup, moved = chip_smoke.flagship(cpu, cpu, n=1200, b=48, map_cells=128,
                                       n_pairs=200)
    chip_smoke.models(cpu, cpu, setup, moved, n=1200, n_beam=60, n_3d=(300, 600),
                      b_3d=32, map_cells=128, n_f64=8)
    out = capsys.readouterr().out
    assert "KLD count" in out and "3D likelihood_field_gompertz spread" in out
    assert not any(line.startswith("{") for line in out.splitlines())


def test_four_card_phase_rehearses_on_virtual_devices(capsys):
    chip_smoke.four_cards(jax.devices()[:4], r=8, n=300, b=16)
    out = capsys.readouterr().out
    assert "fleet_health psum" in out
    health = out.split("fleet_health psum: ")[1].split("; single")[0]
    assert json.loads(health.replace("'", '"'))["mean_active"] > 0
