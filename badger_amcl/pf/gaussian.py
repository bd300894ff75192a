"""Covariance-shaped Gaussian pose sampling.

Replaces the reference's `PDFGaussian` (src/amcl/pf/pdf_gaussian.cpp): the
3x3 covariance is eigendecomposed into rotation x diagonal
(pdf_gaussian.cpp:99-127) and samples are drawn per-axis then rotated
(pdf_gaussian.cpp:53-71). The serial polar Box-Muller `draw`
(pdf_gaussian.cpp:77-97) becomes `jax.random.normal` — JAX PRNG keys replace
the process-global drand48 stream, making determinism principled (the
reference's seedable ctor exists solely for tests, pdf_gaussian.cpp:47-50).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def decompose(cov: jnp.ndarray):
    """cov (3,3) -> (rotation (3,3), per-axis stddev (3,)).

    The reference uses a general (non-symmetric-tolerant) eigensolver and
    keeps the real parts; we symmetrize and use eigh, which is identical for
    the symmetric covariances the system actually produces. Negative
    eigenvalues (ill-formed input) are clamped to zero rather than producing
    NaNs."""
    sym = 0.5 * (cov + cov.T)
    evals, evecs = jnp.linalg.eigh(sym)
    std = jnp.sqrt(jnp.maximum(evals, 0.0))
    return evecs, std


def sample_poses(key: jax.Array, mean: jnp.ndarray, cov: jnp.ndarray, n: int):
    """Draw n poses from N(mean, cov) exactly as PDFGaussian::sample does:
    r_i ~ N(0, std_i) per axis, v = mean + R @ r. Returns (n, 3) f32.
    The rotation runs at Precision.HIGHEST (full float32): the GPU's
    default would take it in TF32, which keeps about three digits."""
    rot, std = decompose(cov)
    r = jax.random.normal(key, (n, 3), dtype=jnp.float32) * std[None, :]
    rotated = jnp.matmul(r, rot.T, precision=jax.lax.Precision.HIGHEST)
    return (mean[None, :] + rotated).astype(jnp.float32)
