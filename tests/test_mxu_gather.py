"""One-hot contraction gather/segment ops (ops/mxu_gather.py): exactness contracts.

One-hot contractions sum exactly one selected term, so results must be
BIT-EQUAL to the scalar gather / scatter-add equivalents (f32 values ride
through the matmul unchanged)."""

import numpy as np
import jax
import jax.numpy as jnp

from badger_amcl.ops import mxu_gather


def test_gather_rows_exact():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(517, 3)).astype(np.float32)
    idx = rng.integers(0, 517, size=2000).astype(np.int32)
    out = np.asarray(mxu_gather.gather_rows(jnp.asarray(data), jnp.asarray(idx)))
    np.testing.assert_array_equal(out, data[idx])


def test_gather_rows_chunk_boundaries():
    data = np.arange(256 * 2, dtype=np.float32).reshape(256, 2)
    idx = np.array([0, 127, 128, 255], np.int32)  # chunk edges
    out = np.asarray(mxu_gather.gather_rows(jnp.asarray(data), jnp.asarray(idx)))
    np.testing.assert_array_equal(out, data[idx])


def test_segment_sums_small_matches_segment_sum():
    rng = np.random.default_rng(1)
    vals = rng.normal(size=(9, 2000)).astype(np.float32)
    seg = rng.integers(0, 7, size=2000).astype(np.int32)
    got = np.asarray(
        mxu_gather.segment_sums_small(jnp.asarray(vals), jnp.asarray(seg), 16)
    )
    want = np.stack([
        np.asarray(jax.ops.segment_sum(jnp.asarray(v), jnp.asarray(seg),
                                       num_segments=16))
        for v in vals
    ])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_segment_sums_small_drops_out_of_range():
    vals = jnp.ones((1, 4), jnp.float32)
    seg = jnp.array([0, 1, 5, 9], jnp.int32)  # 5, 9 >= k -> dropped
    got = np.asarray(mxu_gather.segment_sums_small(vals, seg, 4))
    np.testing.assert_array_equal(got, [[1.0, 1.0, 0.0, 0.0]])

