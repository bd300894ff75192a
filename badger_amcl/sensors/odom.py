"""Odometry motion models, vectorized over the particle axis.

All five variants of the reference's `Odom::updateAction`
(src/amcl/sensors/odom.cpp:74-311) as one jittable transform over the
`(M, 3)` pose array. The serial per-particle loops with polar Box-Muller
draws become batched `jax.random.normal` sampling.

Faithfully preserved quirks:
- DIFF and OMNI pass *variances* directly as the Gaussian sigma (no sqrt) —
  the historic ROS amcl behavior (odom.cpp:98-103,156-162); only the
  *_CORRECTED variants and GAUSSIAN apply sqrt (odom.cpp:181-186,239-247,
  276-278).
- Particle yaw is NOT re-normalized after the update (the reference never
  wraps pose[2]; the KLD histogram and circular statistics both tolerate it).
- DIFF's in-place-rotation guard: delta_rot1 = 0 when translation < 1 cm
  (odom.cpp:134-138,217-222).
"""

from __future__ import annotations

import enum

import jax
import jax.numpy as jnp

from badger_amcl.pf.types import MCLState
from badger_amcl.utils.angles import angle_diff


class OdomModel(enum.IntEnum):
    """OdomModelType (odom.h:33-40)."""

    DIFF = 0
    OMNI = 1
    DIFF_CORRECTED = 2
    OMNI_CORRECTED = 3
    GAUSSIAN = 4


def _draw(key, sigma, n):
    """Batched PDFGaussian::draw: N(0, sigma) — sigma used verbatim, even when
    the caller passes a variance (see module docstring)."""
    return jax.random.normal(key, (n,), dtype=jnp.float32) * sigma


def _apply_omni(poses, key, delta, old_theta, t_std, r_std, s_std):
    n = poses.shape[0]
    k1, k2, k3 = jax.random.split(key, 3)
    delta_trans = jnp.sqrt(delta[0] ** 2 + delta[1] ** 2)
    delta_rot = delta[2]
    turn_angle = jnp.arctan2(delta[1], delta[0])
    bearing = angle_diff(turn_angle, old_theta) + poses[:, 2]
    cs, sn = jnp.cos(bearing), jnp.sin(bearing)
    trans_hat = delta_trans + _draw(k1, t_std, n)
    rot_hat = delta_rot + _draw(k2, r_std, n)
    strafe_hat = _draw(k3, s_std, n)
    x = poses[:, 0] + trans_hat * cs + strafe_hat * sn
    y = poses[:, 1] + trans_hat * sn - strafe_hat * cs
    th = poses[:, 2] + rot_hat
    return jnp.stack([x, y, th], axis=1)


def _apply_diff(poses, key, delta, old_theta, a1, a2, a3, a4, corrected):
    n = poses.shape[0]
    k1, k2, k3 = jax.random.split(key, 3)
    delta_trans = jnp.sqrt(delta[0] ** 2 + delta[1] ** 2)
    rot1 = jnp.where(
        delta_trans < 0.01,
        0.0,
        angle_diff(jnp.arctan2(delta[1], delta[0]), old_theta),
    )
    rot2 = angle_diff(delta[2], rot1)
    # symmetric fwd/bwd noise (odom.cpp:144-149)
    rot1_noise = jnp.minimum(
        jnp.abs(angle_diff(rot1, 0.0)), jnp.abs(angle_diff(rot1, jnp.pi))
    )
    rot2_noise = jnp.minimum(
        jnp.abs(angle_diff(rot2, 0.0)), jnp.abs(angle_diff(rot2, jnp.pi))
    )
    v1 = a1 * rot1_noise**2 + a2 * delta_trans**2
    v2 = a3 * delta_trans**2 + a4 * rot1_noise**2 + a4 * rot2_noise**2
    v3 = a1 * rot2_noise**2 + a2 * delta_trans**2
    if corrected:
        v1, v2, v3 = jnp.sqrt(v1), jnp.sqrt(v2), jnp.sqrt(v3)
    rot1_hat = angle_diff(rot1, _draw(k1, v1, n))
    trans_hat = delta_trans - _draw(k2, v2, n)
    rot2_hat = angle_diff(rot2, _draw(k3, v3, n))
    x = poses[:, 0] + trans_hat * jnp.cos(poses[:, 2] + rot1_hat)
    y = poses[:, 1] + trans_hat * jnp.sin(poses[:, 2] + rot1_hat)
    th = poses[:, 2] + rot1_hat + rot2_hat
    return jnp.stack([x, y, th], axis=1)


def _apply_gaussian(poses, key, delta, old_theta, absolute_motion, a1, a2, a3, a4, a5):
    """ODOM_MODEL_GAUSSIAN (odom.cpp:257-308): deterministic delta applied
    along the bearing, noise magnitudes from integrated absolute motion,
    noise applied along the mid-rotation heading."""
    n = poses.shape[0]
    k1, k2, k3 = jax.random.split(key, 3)
    delta_trans = jnp.sqrt(delta[0] ** 2 + delta[1] ** 2)
    delta_rot = delta[2]
    at2 = absolute_motion[0] ** 2
    as2 = absolute_motion[1] ** 2
    ar2 = absolute_motion[2] ** 2
    rot_std = jnp.sqrt(a1 * ar2 + a2 * at2)
    trans_std = jnp.sqrt(a3 * at2 + a4 * ar2)
    strafe_std = jnp.sqrt(a4 * ar2 + a5 * as2)

    heading = poses[:, 2] + delta[2] / 2.0
    csh, snh = jnp.cos(heading), jnp.sin(heading)
    ndata_angle = jnp.arctan2(delta[1], delta[0])
    bearing = angle_diff(ndata_angle, old_theta) + poses[:, 2]
    csb, snb = jnp.cos(bearing), jnp.sin(bearing)

    trans_hat = _draw(k1, trans_std, n)
    strafe_hat = _draw(k2, strafe_std, n)
    rot_hat = _draw(k3, rot_std, n)

    x = poses[:, 0] + delta_trans * csb + trans_hat * csh + strafe_hat * snh
    y = poses[:, 1] + delta_trans * snb + trans_hat * snh - strafe_hat * csh
    th = poses[:, 2] + delta_rot + rot_hat
    return jnp.stack([x, y, th], axis=1)


def motion_update(
    state: MCLState,
    model: OdomModel,
    alphas,
    pose,
    delta,
    absolute_motion=None,
) -> MCLState:
    """Odom::updateAction. `pose` is the current odom pose, `delta` the odom
    delta since the last filter update (OdomData, odom.h:55-81);
    old_pose = pose - delta (odom.cpp:81-84). `model` is static."""
    pose = jnp.asarray(pose, jnp.float32)
    delta = jnp.asarray(delta, jnp.float32)
    if absolute_motion is None:
        absolute_motion = delta
    absolute_motion = jnp.asarray(absolute_motion, jnp.float32)
    a1, a2, a3, a4, a5 = [jnp.float32(a) for a in alphas]
    old_theta = pose[2] - delta[2]

    key, sub = jax.random.split(state.key)
    model = OdomModel(model)
    if model == OdomModel.OMNI:
        t = a3 * (delta[0] ** 2 + delta[1] ** 2) + a1 * delta[2] ** 2
        r = a4 * delta[2] ** 2 + a2 * (delta[0] ** 2 + delta[1] ** 2)
        s = a1 * delta[2] ** 2 + a5 * (delta[0] ** 2 + delta[1] ** 2)
        new_poses = _apply_omni(state.poses, sub, delta, old_theta, t, r, s)
    elif model == OdomModel.OMNI_CORRECTED:
        t = jnp.sqrt(a3 * (delta[0] ** 2 + delta[1] ** 2) + a1 * delta[2] ** 2)
        r = jnp.sqrt(a4 * delta[2] ** 2 + a2 * (delta[0] ** 2 + delta[1] ** 2))
        s = jnp.sqrt(a1 * delta[2] ** 2 + a5 * (delta[0] ** 2 + delta[1] ** 2))
        new_poses = _apply_omni(state.poses, sub, delta, old_theta, t, r, s)
    elif model == OdomModel.DIFF:
        new_poses = _apply_diff(
            state.poses, sub, delta, old_theta, a1, a2, a3, a4, corrected=False
        )
    elif model == OdomModel.DIFF_CORRECTED:
        new_poses = _apply_diff(
            state.poses, sub, delta, old_theta, a1, a2, a3, a4, corrected=True
        )
    elif model == OdomModel.GAUSSIAN:
        new_poses = _apply_gaussian(
            state.poses, sub, delta, old_theta, absolute_motion, a1, a2, a3, a4, a5
        )
    else:  # pragma: no cover
        raise ValueError(f"unknown odom model {model}")
    return state.replace(poses=new_poses.astype(jnp.float32), key=key)
