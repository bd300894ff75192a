"""One-hot matrix-contraction forms of row gathers and segment sums.

Both primitives reshape an indexed read or scatter so that a matrix unit
does the data movement instead of a per-element gather or scatter loop.
They were written for a machine whose compiler lowered gathers and
scatters poorly; whether they beat `jnp.take` / `jax.ops.segment_sum` on
the GPU is an open measurement (ROADMAP.md Queue 1).

- `gather_rows`: out[q] = data[idx[q]] via a two-level chunked one-hot —
  a (Q, n_chunks) f32 one-hot contraction fetches each query's 128-row
  chunk, then an in-chunk one-hot multiply-reduce picks the row. Exact
  (one-hot matmuls sum a single nonzero term, so no rounding beyond the
  values themselves).

- `segment_sums_small`: simultaneous segment sums of several quantities
  when segment ids are bounded by a small static K (cluster ranks are;
  particle counts per cluster are not needed individually): a (Q, K)
  one-hot matmul replaces K-independent scatter-adds. Used by
  pf/cluster.py for the per-cluster statistics
  (computeClusterStatsForSet, particle_filter.cpp:505-636).

- `broadcast_small`: the transpose — each query reads its entry of a small
  table.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

_CHUNK = 128

# Every contraction runs at HIGHEST: full float32. A lower precision
# (TF32 on the GPU's tensor cores, bf16 elsewhere) would truncate the DATA
# operand (resampled poses, second moments E[x^2] whose cancellation
# against E[x]^2 would be swamped far from the origin) and break the
# "exact one-hot" contract. The one-hot operands are cheap either way.
_PRECISION = lax.Precision.HIGHEST


def gather_rows(data: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """data (n, d) f32, idx (q,) int32 in [0, n) -> (q, d) == data[idx].

    Exact: each output row is the sum of exactly one selected row."""
    n, d = data.shape
    q = idx.shape[0]
    n_pad = -(-n // _CHUNK) * _CHUNK
    n_chunks = n_pad // _CHUNK
    data_pad = jnp.zeros((n_pad, d), data.dtype).at[:n].set(data)
    data_r = data_pad.reshape(n_chunks, _CHUNK * d)

    ci = (idx // _CHUNK).astype(jnp.int32)
    within = (idx - ci * _CHUNK).astype(jnp.int32)

    onehot_c = (ci[:, None] == jnp.arange(n_chunks, dtype=jnp.int32)[None, :]).astype(
        data.dtype
    )
    rows = lax.dot_general(
        onehot_c, data_r, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=data.dtype, precision=_PRECISION,
    ).reshape(q, _CHUNK, d)
    onehot_w = (within[:, None] == jnp.arange(_CHUNK, dtype=jnp.int32)[None, :]).astype(
        data.dtype
    )
    return jnp.sum(rows * onehot_w[:, :, None], axis=1)


def segment_sums_small(values: jnp.ndarray, seg_ids: jnp.ndarray, k: int) -> jnp.ndarray:
    """values (v, q), seg_ids (q,) int32 — sum each of the v quantities per
    segment, for segment ids < k (static). Ids >= k are DROPPED (matching
    segment_sum's out-of-range drop semantics). Returns (v, k)."""
    onehot = (seg_ids[:, None] == jnp.arange(k, dtype=jnp.int32)[None, :]).astype(
        values.dtype
    )
    return lax.dot_general(
        values, onehot, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=values.dtype, precision=_PRECISION,
    )


def broadcast_small(table: jnp.ndarray, ids: jnp.ndarray) -> jnp.ndarray:
    """out[q] = table[ids[q]] for a SMALL 1-D f32 table (k <= a few
    thousand) and many queries — chunked one-hot contraction; exact.
    Out-of-range ids return 0."""
    k = table.shape[0]
    k_pad = -(-k // _CHUNK) * _CHUNK
    n_chunks = k_pad // _CHUNK
    t2 = jnp.zeros((k_pad,), table.dtype).at[:k].set(table)
    t2 = t2.reshape(n_chunks, _CHUNK)
    ci = (ids // _CHUNK).astype(jnp.int32)
    onehot_c = (ci[:, None] == jnp.arange(n_chunks, dtype=jnp.int32)[None, :]
                ).astype(table.dtype)
    rows = lax.dot_general(
        onehot_c, t2, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=table.dtype, precision=_PRECISION,
    )  # (q, _CHUNK)
    within = (ids - ci * _CHUNK).astype(jnp.int32)
    inner = within[:, None] == jnp.arange(_CHUNK, dtype=jnp.int32)[None, :]
    return jnp.sum(jnp.where(inner, rows, 0), axis=1)

