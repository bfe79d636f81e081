"""Native (C++) graph-preprocessing tests against the Python reference."""

import time

import numpy as np
import pytest

from gwen import native
from gwen.graph import apply_order, bandwidth, icosphere_edges
from gwen.graph.reorder import rcm_order

pytestmark = pytest.mark.skipif(
    native.get_lib() is None, reason="g++ toolchain unavailable"
)


def test_native_bandwidth_matches():
    verts, s, r = icosphere_edges(2)
    assert native.bandwidth(s, r) == bandwidth(s, r)


def test_native_rcm_valid_permutation_and_bandwidth():
    verts, s, r = icosphere_edges(3)
    n = verts.shape[0]
    perm_native = native.rcm_order(s, r, n)
    assert sorted(perm_native) == list(range(n))
    s2, r2, _ = apply_order(perm_native, s, r)
    perm_py = rcm_order(s, r, n, native=False)
    s3, r3, _ = apply_order(perm_py, s, r)
    # Native ordering must be at least as good as (close to) the Python one.
    assert bandwidth(s2, r2) <= bandwidth(s3, r3) * 1.5
    assert bandwidth(s2, r2) < bandwidth(s, r)


def test_native_rcm_much_faster():
    verts, s, r = icosphere_edges(5)  # 10242 nodes
    n = verts.shape[0]
    t0 = time.perf_counter()
    native.rcm_order(s, r, n)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    rcm_order(s, r, n, native=False)
    t_py = time.perf_counter() - t0
    assert t_native < t_py  # typically 100-1000x


def test_native_rejects_bad_edges():
    with pytest.raises(ValueError):
        native.rcm_order(np.array([0, 99]), np.array([1, 0]), 3)
