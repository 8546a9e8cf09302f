"""The port's DCT (dimsum_torch/ops/dct.py) and the DCT-blurred interpolant
(`transport/path.py::dct_blur`, ICPlan's `use_blurring`) against the JAX
package's, on seeded numpy inputs.

Tolerances: fp32, 1e-6 on O(1) values (the same fp32 basis, the products
summed in another order); 1e-5 where the unnormalized DCT scales the
values by up to sqrt(2 n), and for the round trips back to x."""

import numpy as np
import pytest
import torch

from dimsum_tpu.ops import dct as jax_dct
from dimsum_tpu.transport import create_transport as jax_create_transport
from dimsum_tpu.transport.path import dct_blur as jax_dct_blur
from dimsum_torch.ops import dct
from dimsum_torch.transport import create_transport
from dimsum_torch.transport.path import dct_blur
from tests.test_torch_convert import torch_one_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_basis_equals_jax(n):
    np.testing.assert_array_equal(dct.dct_basis(n).numpy(),
                                  np.asarray(jax_dct.dct_basis(n)))


def test_basis_is_made_once_and_serves_a_backward():
    """The basis is one tensor a device, made outside inference mode: a
    basis first made while sampling is saved for a later backward."""
    n = 5  # a size no other test makes first
    with torch.inference_mode():
        y = dct.dct_patch(torch.ones(1, 1, n, n), n)
    assert dct.dct_basis(n) is dct.dct_basis(n, "cpu")
    assert not dct.dct_basis(n).is_inference()
    x = torch.from_numpy(_x((1, 2, n, n))).requires_grad_(True)
    dct.idct_patch(dct.dct_patch(x, n), n).sum().backward()
    torch.testing.assert_close(x.grad, torch.ones_like(x), **TOL)
    assert y.shape == (1, n * n, 1, 1)


@pytest.mark.parametrize("k, r", [(4, 4), (2, 2), (4, 2)])
def test_dct_patch_and_inverse_match_jax(k, r):
    x = _x((2, 3, 8, 8))
    got = dct.dct_patch(torch.from_numpy(x), k, r)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_dct.dct_patch(x, k, r)), **TOL)
    back = dct.idct_patch(got, k, r)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jax_dct.idct_patch(got.numpy(), k, r)),
        **TOL)
    if r == k:  # the full basis is orthonormal: the round trip is exact
        np.testing.assert_allclose(back.numpy(), x, **TOL)


@pytest.mark.parametrize("norm", ["ortho", None])
@pytest.mark.parametrize("size, H", [(4, 16), (8, 8)])
def test_dct_2d_and_inverse_match_jax(norm, size, H):
    x = _x((2, 4, H, H), seed=size)
    got = dct.dct_2d(torch.from_numpy(x), size, norm=norm)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_dct.dct_2d(x, size, norm=norm)),
        rtol=1e-6, atol=1e-5 if norm is None else 1e-6)
    back = dct.idct_2d(got, size, norm=norm)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jax_dct.idct_2d(got.numpy(), size,
                                                 norm=norm)), **TOL)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-5, atol=1e-5)


def test_dct_blur_matches_jax():
    x = _x((3, 4, 16, 16), seed=1)
    sig = np.array([0.0, 1.0, 3.0], np.float32).reshape(3, 1, 1, 1)
    got = dct_blur(torch.from_numpy(x), 4, torch.from_numpy(sig))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_dct_blur(x, 4, sig)), **TOL)
    # sigma 0 keeps x; a blur keeps each patch's mean (the DC coefficient)
    np.testing.assert_allclose(got[0].numpy(), x[0], rtol=1e-5, atol=1e-5)
    patch_mean = got.reshape(3, 4, 4, 4, 4, 4).mean((3, 5))
    np.testing.assert_allclose(
        patch_mean.numpy(), x.reshape(3, 4, 4, 4, 4, 4).mean((3, 5)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("path", ["Linear", "GVP"])
def test_blurring_plan_matches_jax(path):
    args = {"use_blurring": True, "blur_sigma_max": 3, "blur_upscale": 4}
    jp = jax_create_transport(path, "velocity", path_args=args).path_sampler
    pp = create_transport(path, "velocity", path_args=args).path_sampler
    x0, x1 = _x((4, 4, 16, 16), 2), _x((4, 4, 16, 16), 3)
    t = np.array([0.05, 0.3, 0.6, 0.95], np.float32)
    want_t, want_xt, want_ut = jp.plan(t, x0, x1)
    got_t, got_xt, got_ut = pp.plan(*(torch.from_numpy(a)
                                      for a in (t, x0, x1)))
    np.testing.assert_allclose(got_xt.numpy(), np.asarray(want_xt), **TOL)
    np.testing.assert_allclose(got_ut.numpy(), np.asarray(want_ut), **TOL)
    # the blur acts: x_t differs from the unblurred interpolant
    plain = create_transport(path, "velocity").path_sampler
    _, xt, _ = plain.plan(*(torch.from_numpy(a) for a in (t, x0, x1)))
    assert (xt - got_xt).abs().max() > 1e-3
