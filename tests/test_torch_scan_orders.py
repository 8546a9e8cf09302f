"""The port's scan-path zoo (dimsum_torch/ops/scan_orders.py) against the
JAX package's: every path of every zoo, the inverse permutations and the
per-layer tables of the zigzag scan types, equal as integer arrays (the
builders are numpy in both packages); and the gather along L."""

import numpy as np
import pytest
import torch

from dimsum_tpu.ops import scan_orders as jax_orders
from dimsum_torch.ops import scan_orders
from tests.test_torch_convert import torch_one_thread  # noqa: F401


@pytest.mark.parametrize("zoo", ["sweep", "zigma", "jpeg"])
@pytest.mark.parametrize("N", [2, 5, 8, 16])
def test_zoo_paths_equal_jax(zoo, N):
    want = jax_orders.SCAN_ZOO[zoo](N)
    got = scan_orders.SCAN_ZOO[zoo](N)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        # each is a permutation of the grid, and its inverse undoes it
        np.testing.assert_array_equal(np.sort(g), np.arange(N * N))
        inv = scan_orders.reverse_permut_np(g)
        np.testing.assert_array_equal(inv, jax_orders.reverse_permut_np(w))
        np.testing.assert_array_equal(g[inv], np.arange(N * N))


@pytest.mark.parametrize("scan_type", ["zigma_8", "sweep_8", "jpeg_8",
                                       "sweep_4", "jpeg_2"])
@pytest.mark.parametrize("grid", [8, 16])
def test_layer_paths_equal_jax(scan_type, grid):
    want_f, want_b = jax_orders.build_layer_paths(grid, scan_type, 4)
    got_f, got_b = scan_orders.build_layer_paths(grid, scan_type, 4)
    for g, w in ((got_f, want_f), (got_b, want_b)):
        assert g.dtype == np.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g, np.asarray(w))


def test_apply_permutation_gathers_along_L():
    x = np.random.default_rng(0).standard_normal((2, 16, 3)).astype(
        np.float32)
    perm = scan_orders.jpeg_zigzag(4)[3]
    got = scan_orders.apply_permutation(torch.from_numpy(x), perm)
    want = jax_orders.apply_permutation(x, perm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
