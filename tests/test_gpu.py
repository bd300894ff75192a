"""Checks on the NVIDIA GPU: the exact XLA path compiled for the card
against the same program on the CPU device, at moderate widths. They skip
without a GPU; chip_smoke.py runs the same comparisons at full width.

Run on the card:  JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import math

import jax
import numpy as np
import pytest

import chip_smoke
from __graft_entry__ import _build_setup

pytestmark = pytest.mark.gpu


def test_likelihood_field_gpu_matches_cpu(gpu):
    cpu = jax.devices("cpu")[0]
    setup = _build_setup(4000, 180, 512)
    omap, _, state, scan, sp, _ = setup
    z_dev, z_ref = chip_smoke.on_both(
        chip_smoke.planar_lookups, (state.poses, omap, sp, scan), gpu, cpu)
    moved = chip_smoke.compare_lookups("lookups", z_dev, z_ref,
                                       omap.resolution * math.sqrt(2.0))
    for model in ("likelihood_field", "likelihood_field_gompertz"):
        chip_smoke.planar_model(model, gpu, cpu, setup, model, moved, n_f64=32)


def test_beam_ranges_gpu_match_cpu(gpu):
    cpu = jax.devices("cpu")[0]
    omap, _, state, scan, sp, _ = _build_setup(500, 180, 512, pose_cov=(0.02, 0.02, 0.002))
    r_dev, r_ref = chip_smoke.on_both(
        chip_smoke.beam_ranges, (state.poses, omap, sp, scan), gpu, cpu)
    chip_smoke.compare_lookups("beam ranges", r_dev, r_ref,
                               omap.resolution * math.sqrt(2.0),
                               rounding=chip_smoke.RANGE_ROUNDING)
    assert np.isfinite(r_dev).all()
