"""Full filter-state checkpointing.

The reference only checkpoints the pose estimate (saved-pose YAML,
node.cpp:608-668) and rebuilds the particle set from a Gaussian on restart.
With device arrays the full set is trivial to snapshot (SURVEY.md §5
recommends it), so this module adds an optional richer checkpoint: the
complete MCLState (poses, weights, PRNG key, recovery averages, convergence)
as a single .npz with crash-safe write. Restart resumes the exact particle
distribution — valuable for multi-modal situations where the Gaussian rebuild
would collapse hypotheses.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from badger_amcl.pf.types import MCLState, PFParams, empty_cluster_stats

_FORMAT_VERSION = 1


def save_state(path: str, state: MCLState) -> None:
    """Crash-safe snapshot of the full filter state."""
    key_data = jax.random.key_data(state.key)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".amcl_state_", suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                version=_FORMAT_VERSION,
                poses=np.asarray(state.poses),
                weights=np.asarray(state.weights),
                n_active=np.asarray(state.n_active),
                key_data=np.asarray(key_data),
                w_slow=np.asarray(state.w_slow),
                w_fast=np.asarray(state.w_fast),
                alpha_slow=np.asarray(state.alpha_slow),
                alpha_fast=np.asarray(state.alpha_fast),
                converged=np.asarray(state.converged),
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_state(path: str, params: PFParams) -> Optional[MCLState]:
    """Restore a snapshot; None on missing/corrupt/capacity-mismatched files.
    Cluster statistics are recomputed (they are derived state)."""
    try:
        with np.load(path) as z:
            if int(z["version"]) != _FORMAT_VERSION:
                return None
            poses = z["poses"]
            if poses.shape != (params.max_samples, 3):
                return None
            key = jax.random.wrap_key_data(jnp.asarray(z["key_data"]))
            state = MCLState(
                poses=jnp.asarray(poses, jnp.float32),
                weights=jnp.asarray(z["weights"], jnp.float32),
                n_active=jnp.asarray(z["n_active"], jnp.int32),
                key=key,
                w_slow=jnp.asarray(z["w_slow"], jnp.float32),
                w_fast=jnp.asarray(z["w_fast"], jnp.float32),
                alpha_slow=jnp.asarray(z["alpha_slow"], jnp.float32),
                alpha_fast=jnp.asarray(z["alpha_fast"], jnp.float32),
                converged=jnp.asarray(z["converged"], bool),
                stats=empty_cluster_stats(params.max_samples),
            )
    except (OSError, ValueError, KeyError):
        return None
    from badger_amcl.pf import cluster

    stats = cluster.compute_cluster_stats(
        state.poses, state.weights, state.active_mask, params
    )
    return state.replace(stats=stats)
