"""sensor_update(state, p*mf, None) == sensor_update(state, p, mf): the
map factor may be applied folded into p or separately (pf/filter.py
sensor_update docstring)."""

import numpy as np
import jax
import jax.numpy as jnp

from badger_amcl.pf import filter as pf_filter
from badger_amcl.pf.types import PFParams


def test_sensor_update_folded_equivalence():
    """sensor_update(state, p*mf, None) == sensor_update(state, p, mf),
    including the zero-total uniform-reset corner."""
    m = 64
    params = PFParams(min_samples=8, max_samples=m)
    key = jax.random.PRNGKey(0)
    state = pf_filter.init_with_gaussian(
        params, key, jnp.zeros(3), jnp.eye(3) * 0.01)
    p = jax.random.uniform(jax.random.PRNGKey(1), (m,), minval=0.0, maxval=2.0)
    mf = jax.random.uniform(jax.random.PRNGKey(2), (m,), minval=0.0, maxval=1.0)
    a = pf_filter.sensor_update(state, p, mf)
    b = pf_filter.sensor_update(state, p * mf, None)
    np.testing.assert_allclose(np.asarray(a.weights), np.asarray(b.weights),
                               rtol=1e-6)
    np.testing.assert_allclose(float(a.w_slow), float(b.w_slow), rtol=1e-6)
    np.testing.assert_allclose(float(a.w_fast), float(b.w_fast), rtol=1e-6)
    # zero factors everywhere -> both reset to uniform, averages untouched
    z = pf_filter.sensor_update(state, p, jnp.zeros((m,)))
    zf = pf_filter.sensor_update(state, p * 0.0, None)
    np.testing.assert_array_equal(np.asarray(z.weights), np.asarray(zf.weights))
    assert float(z.w_slow) == float(zf.w_slow)
