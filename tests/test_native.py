"""Native C++ EDT vs the numpy reference implementation."""

import numpy as np
import pytest

from badger_amcl.maps.edt import edt_2d, edt_3d
from badger_amcl.utils import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built (make -C native)"
)


def test_native_2d_matches_numpy():
    rng = np.random.default_rng(1)
    occ = rng.random((123, 217)) < 0.04
    occ[50, 60] = True
    np.testing.assert_allclose(native.edt_cells(occ), edt_2d(occ), atol=1e-9)


def test_native_3d_matches_numpy():
    rng = np.random.default_rng(2)
    occ = rng.random((31, 27, 19)) < 0.02
    occ[10, 10, 10] = True
    np.testing.assert_allclose(native.edt_cells(occ), edt_3d(occ), atol=1e-9)


def test_native_edge_cases():
    # all occupied
    occ = np.ones((8, 8), bool)
    assert (native.edt_cells(occ) == 0).all()
    # empty: huge sentinel distances, no NaN
    occ = np.zeros((8, 8), bool)
    out = native.edt_cells(occ)
    assert np.isfinite(out).all() and (out > 1e8).all()
    # single row / column shapes
    occ = np.zeros((1, 16), bool)
    occ[0, 5] = True
    want = np.abs(np.arange(16) - 5)
    np.testing.assert_allclose(native.edt_cells(occ)[0], want)
