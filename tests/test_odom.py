"""Odometry motion models: deterministic parts exactly, noise statistically.

Golden contracts from src/amcl/sensors/odom.cpp:74-311, including the
preserved variance-as-sigma quirk of the non-corrected models.
"""

import jax
import jax.numpy as jnp
import numpy as np

from badger_amcl.pf import PFParams, init_with_poses
from badger_amcl.sensors import OdomModel, motion_update

N = 20000
PARAMS = PFParams(max_samples=N)


def _state_at(pose, key=0):
    poses = jnp.broadcast_to(jnp.asarray(pose, jnp.float32), (N, 3))
    return init_with_poses(PARAMS, jax.random.PRNGKey(key), poses)


def test_diff_zero_noise_exact():
    """With all alphas 0 the DIFF model is the deterministic rot1-trans-rot2
    decomposition (Prob.Rob. p.136)."""
    st = _state_at([1.0, 2.0, 0.5])
    pose = jnp.array([3.0, 1.0, 0.9])
    delta = jnp.array([0.3, 0.4, 0.2])
    st2 = motion_update(st, OdomModel.DIFF, (0, 0, 0, 0, 0), pose, delta)
    old_theta = 0.9 - 0.2
    trans = 0.5
    rot1 = np.arctan2(0.4, 0.3) - old_theta
    rot2 = 0.2 - rot1
    want = np.array(
        [
            1.0 + trans * np.cos(0.5 + rot1),
            2.0 + trans * np.sin(0.5 + rot1),
            0.5 + rot1 + rot2,
        ]
    )
    np.testing.assert_allclose(np.asarray(st2.poses)[0], want, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(st2.poses)[123], want, rtol=1e-5)


def test_diff_in_place_rotation_guard():
    """Translation < 1 cm forces delta_rot1 = 0 (odom.cpp:134-138)."""
    st = _state_at([0.0, 0.0, 1.0])
    pose = jnp.array([0.0, 0.0, 0.5])
    delta = jnp.array([0.005, 0.0, 0.3])
    st2 = motion_update(st, OdomModel.DIFF, (0, 0, 0, 0, 0), pose, delta)
    p = np.asarray(st2.poses)[0]
    np.testing.assert_allclose(p[2], 1.3, rtol=1e-5)  # rot1=0, rot2=0.3


def test_omni_zero_noise_exact():
    st = _state_at([1.0, 1.0, np.pi / 2])
    pose = jnp.array([2.0, 0.0, 0.0])
    delta = jnp.array([0.5, 0.0, 0.1])
    st2 = motion_update(st, OdomModel.OMNI, (0, 0, 0, 0, 0), pose, delta)
    old_theta = 0.0 - 0.1
    bearing = (np.arctan2(0.0, 0.5) - old_theta) + np.pi / 2
    want = np.array(
        [1.0 + 0.5 * np.cos(bearing), 1.0 + 0.5 * np.sin(bearing), np.pi / 2 + 0.1]
    )
    np.testing.assert_allclose(np.asarray(st2.poses)[0], want, rtol=1e-5, atol=1e-6)


def test_noncorrected_variance_as_sigma_quirk():
    """DIFF passes a1*rot1n^2 + a2*trans^2 straight to draw() as sigma
    (odom.cpp:156-162); DIFF_CORRECTED takes the sqrt (odom.cpp:239-247).
    With pure translation the yaw spread must differ accordingly."""
    pose = jnp.array([1.0, 0.0, 0.0])
    delta = jnp.array([1.0, 0.0, 0.0])  # trans=1, rot1n=rot2n=0
    a = (0.04, 0.04, 0.0, 0.0, 0.0)  # alpha2 drives rot noise: var=0.04
    st = _state_at([0, 0, 0], key=1)
    plain = motion_update(st, OdomModel.DIFF, a, pose, delta)
    corr = motion_update(st, OdomModel.DIFF_CORRECTED, a, pose, delta)
    # rot1_hat std: plain sigma = 0.04 (variance used raw); corrected = 0.2
    std_plain = np.asarray(plain.poses)[:, 2].std()
    std_corr = np.asarray(corr.poses)[:, 2].std()
    # yaw = rot1_hat + rot2_hat, two independent draws -> std*sqrt(2)
    np.testing.assert_allclose(std_plain, 0.04 * np.sqrt(2), rtol=0.05)
    np.testing.assert_allclose(std_corr, 0.2 * np.sqrt(2), rtol=0.05)


def test_omni_strafe_noise_axis():
    """OMNI strafe noise acts perpendicular to the bearing (odom.cpp:119-121)."""
    pose = jnp.array([1.0, 0.0, 0.0])
    delta = jnp.array([1.0, 0.0, 0.0])
    # only alpha5 (strafe from trans) nonzero: strafe var = a5*trans^2 = 0.09
    a = (0.0, 0.0, 0.0, 0.0, 0.09)
    st = _state_at([0, 0, 0], key=2)
    out = motion_update(st, OdomModel.OMNI, a, pose, delta)
    p = np.asarray(out.poses)
    assert p[:, 0].std() < 1e-5  # no forward noise
    np.testing.assert_allclose(p[:, 1].std(), 0.09, rtol=0.05)  # variance-as-sigma
    np.testing.assert_allclose(p[:, 0].mean(), 1.0, atol=1e-4)  # 0 + trans*cos(0)


def test_gaussian_model_absolute_motion():
    """GAUSSIAN: noise sigmas from integrated absolute motion with sqrt
    (odom.cpp:276-278), deterministic delta along the bearing."""
    pose = jnp.array([2.0, 0.0, 0.0])
    delta = jnp.array([1.0, 0.0, 0.0])
    absm = jnp.array([2.0, 0.0, 0.0])  # accumulated |trans| = 2
    a = (0.0, 0.0, 0.01, 0.0, 0.0)  # trans_std = sqrt(a3 * 4) = 0.2
    st = _state_at([0, 0, 0], key=3)
    out = motion_update(st, OdomModel.GAUSSIAN, a, pose, delta, absm)
    p = np.asarray(out.poses)
    np.testing.assert_allclose(p[:, 0].mean(), 1.0, atol=0.01)
    np.testing.assert_allclose(p[:, 0].std(), 0.2, rtol=0.05)
    assert p[:, 2].std() < 1e-6


def test_yaw_not_renormalized():
    """The reference never wraps particle yaw; preserve that."""
    st = _state_at([0.0, 0.0, 3.0])
    pose = jnp.array([0.0, 0.0, 3.5])
    delta = jnp.array([0.0, 0.0, 0.5])
    out = motion_update(st, OdomModel.OMNI, (0, 0, 0, 0, 0), pose, delta)
    np.testing.assert_allclose(np.asarray(out.poses)[0, 2], 3.5, rtol=1e-6)
