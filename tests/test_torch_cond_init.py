"""`use_cond_init` in the port against the JAX package: the scan seeded
from h0 = cond_proj(c) * 1_N (the state before step 0).

  * The h0 training route's plain versions (kernel 2's with h0 in, kernel
    3's with dh0 out) through `SelectiveScanDtLowFn` on the CPU, against
    `jax.grad` of `selective_scan_xla(u, dt_low @ dt_w, ..., h0=h0)`:
    every input's gradient, h0's included, at an L that is and one that is
    not a multiple of the chunk.  Their chunk-parallel forms (the state
    pass from h0; the carry pass one chunk further, to dh0) against the
    sequential walks, and h0 = 0 against the h0-free route bit for bit.
  * A small DiM with `cond_mamba` and `use_cond_init` (latent 16, hidden
    64, depth 2): the published combined block, and linear + v2 (whose
    `_b` branch runs reversed between flips): forward, CFG, the GVP
    velocity loss and every gradient, cond_proj's among them (zero without
    cond_init).

Tolerances, fp32: 1e-4 of each output's and gradient's scale (the XLA
route is an associative scan, the port's plain versions the sequential
recurrence)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dimsum_tpu.models.dim import DiM as JaxDiM
from dimsum_tpu.models.dim import DiMConfig as JaxDiMConfig
from dimsum_tpu.ops.selective_scan import selective_scan_xla
from dimsum_torch.ops.selective_scan import (
    SelectiveScanDtLowFn, TRAIN_CHUNK, selective_scan_bwd_carry_ref,
    selective_scan_bwd_core_ref, selective_scan_dtlow,
    selective_scan_fwd_train_ref, selective_scan_fwd_train_states_ref)
from dimsum_torch.models.dim import DiM, DiMConfig
from dimsum_torch.utils.convert import state_dict_from_jax_params
from tests.test_torch_convert import torch_one_thread  # noqa: F401
from tests.test_torch_dit import forward_and_cfg, jax_port_pair, \
    loss_and_grads
from tests.test_torch_scan_train import (NAMES, _port_args, _t,
                                         assert_close_scaled, make_inputs)

COND_DIMS = {
    "combined": dict(img_resolution=16, hidden_size=64, depth=2,
                     num_classes=10, label_dropout=0.1, rms_norm=True,
                     cond_mamba=True, use_cond_init=True,
                     learnable_pe=True, block_type="combined",
                     scan_type="none", use_attn_every_k_layers=2),
    "linear-v2": dict(img_resolution=16, hidden_size=64, depth=2,
                      num_classes=10, label_dropout=0.1, rms_norm=False,
                      cond_mamba=True, use_cond_init=True,
                      learnable_pe=False, block_type="linear",
                      scan_type="v2", use_attn_every_k_layers=-1),
}


def _with_h0(x, seed=7):
    batch, _, dim = x["u"].shape
    n = x["A"].shape[1]
    h0 = np.random.default_rng(seed).standard_normal((batch, dim, n))
    return dict(x, h0=h0.astype(np.float32))


@pytest.mark.parametrize("L", [32, 40])
def test_h0_training_route_matches_jax_grad(L):
    x = _with_h0(make_inputs(11, L=L))
    g = np.random.default_rng(12).standard_normal(x["u"].shape).astype(
        np.float32)
    names = NAMES + ("h0",)

    def jax_loss(*leaves):
        a = dict(zip(names, leaves))
        delta = jnp.einsum("blr,rd->bld", a["dt_low"], a["dt_w"])
        y = selective_scan_xla(a["u"], delta, a["A"], a["B"], a["C"],
                               a["D"], z=a["z"], delta_bias=a["bias"],
                               delta_softplus=True, h0=a["h0"])
        return jnp.sum(y * g), y

    (_, want_y), want = jax.value_and_grad(
        jax_loss, argnums=tuple(range(len(names))), has_aux=True)(
        *(jnp.asarray(x[k]) for k in names))
    t = {k: v.requires_grad_(True) for k, v in _t(x).items()}
    y = SelectiveScanDtLowFn.apply(*(t[k] for k in NAMES), True, t["h0"])
    got = torch.autograd.grad(y, [t[k] for k in names],
                              torch.from_numpy(g))
    assert_close_scaled(y.detach().numpy(), want_y, name="y")
    for name, a, b in zip(names, got, want):
        assert_close_scaled(a.numpy(), b, name=name)


@pytest.mark.parametrize("L", [32, 40, 7])
def test_h0_chunk_parallel_forms_match_sequential(L):
    x = _t(_with_h0(make_inputs(13, L=L)))
    args, kw = _port_args(x)
    _, _, bnd = selective_scan_fwd_train_ref(*args, **kw, h0=x["h0"])
    torch.testing.assert_close(bnd[:, 0], x["h0"].transpose(1, 2))
    states = selective_scan_fwd_train_states_ref(
        *args[:5], delta_bias=x["bias"], delta_softplus=True, h0=x["h0"])
    assert_close_scaled(states.numpy(), bnd.numpy(), name="states")
    go = torch.from_numpy(np.random.default_rng(14).standard_normal(
        x["u"].shape).astype(np.float32))
    *_, dh0 = selective_scan_bwd_core_ref(*args, x["bias"], True, go, bnd,
                                          return_dh0=True)
    w, carry_dh0 = selective_scan_bwd_carry_ref(
        x["dt_low"], x["dt_w"], x["A"], x["C"], x["bias"], True, go,
        return_dh0=True)
    assert w.shape[1] == -(-L // TRAIN_CHUNK)
    assert dh0.shape == x["h0"].shape
    assert_close_scaled(carry_dh0.numpy(), dh0.numpy(), name="dh0")


def test_zero_h0_is_the_h0_free_route_bit_for_bit():
    x = _t(make_inputs(15, L=40))
    args, kw = _port_args(x)
    batch, _, dim = x["u"].shape
    zero = torch.zeros(batch, dim, x["A"].shape[1])
    for a, b in zip(selective_scan_fwd_train_ref(*args, **kw, h0=zero),
                    selective_scan_fwd_train_ref(*args, **kw)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    y0 = selective_scan_dtlow(*args, **kw, h0=zero)
    assert torch.isfinite(y0).all()


def test_reverse_with_h0_is_refused():
    x = _t(_with_h0(make_inputs(16)))
    args, kw = _port_args(x)
    with pytest.raises(NotImplementedError, match="reverse"):
        selective_scan_dtlow(*args, **kw, h0=x["h0"], reverse=True)


@pytest.fixture(scope="module", params=list(COND_DIMS))
def cond_dim(request):
    kw = COND_DIMS[request.param]
    jmodel = JaxDiM(JaxDiMConfig(**kw))
    params, port = jax_port_pair(jmodel, DiM(DiMConfig(**kw)), seed=2)
    return kw, jmodel, params, port


def test_cond_init_dim_forward_and_cfg_match_jax(cond_dim):
    kw, jmodel, params, port = cond_dim
    got = forward_and_cfg(jmodel, params, port)
    # the seeded scans change the output: cond_proj is live
    off = DiM(DiMConfig(**dict(kw, use_cond_init=False)))
    off.load_state_dict(port.state_dict(), strict=True)
    x, t, y = (torch.zeros(2, 4, 16, 16), torch.full((2,), 0.5),
               torch.tensor([1, 2]))
    with torch.no_grad():
        assert not torch.equal(off.eval()(x, t, y), port.eval()(x, t, y))
    assert got.abs().max() > 0


def test_cond_init_dim_loss_and_grads_match_jax(cond_dim):
    kw, jmodel, params, _ = cond_dim
    port = DiM(DiMConfig(**kw))
    port.load_state_dict(state_dict_from_jax_params(params), strict=True)
    got = loss_and_grads(jmodel, params, port)
    cond = [n for n in got if n.endswith("mixer.cond_proj.weight")]
    assert cond and all(got[n].abs().max() > 0 for n in cond)
