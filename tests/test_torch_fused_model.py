"""The JAX package's fused-kernel configuration of the port against the JAX
package, on the small DiM (hidden 128, depth 4, a shared DiT block after
the 4th, grid 16: every norm site has D % 128 == 0 and every mixer
d_inner 128, so each site takes the kernels in both packages).

The JAX side runs its three Pallas kernels as its own tests do on the CPU:
`DIMSUM_NORM_INTERPRET=1` (both norm kernels at every eligible site),
`DIMSUM_CONV_XPROJ=1` inside `pltpu.force_tpu_interpret_mode()`, and
`DIMSUM_PENDING_TAIL` for the deferred sites.  The port runs with its
`DiMConfig` switches on; on the CPU its kernel routes take the kernels'
plain versions.  Weights go across with `state_dict_from_jax_params`.

  * forward, CFG and a 4-step Euler sample at pending_tail 0 and 2, fp32,
    5e-5 (the tolerance of the small DiM in tests/test_torch_dim.py; the
    JAX CPU scan is a tree scan, the port's sequential);
  * the training loss (1e-5 relative) and every gradient (1e-3 of each
    tensor's scale), with the draws injected as tests/test_torch_train.py
    injects them;
  * which sites take a kernel, counted per route, at each setting;
  * with the switches off the output is the one the port gave before the
    switches existed, bit for bit: the SHA-256 of its bytes, taken from the
    same `build_dim(..., seed=0)` model and inputs on the commit before
    them."""

import hashlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import dimsum_tpu.models.blocks as jax_blocks
import dimsum_torch.models.blocks as port_blocks
from dimsum_tpu.models.dim import DiM as JaxDiM
from dimsum_tpu.models.dim import DiMConfig as JaxDiMConfig
from dimsum_tpu.models.dim import forward_with_cfg as jax_forward_with_cfg
from dimsum_tpu.transport import create_transport as jax_create_transport
from dimsum_torch.models.dim import DiM, DiMConfig, build_dim, forward_with_cfg
from dimsum_torch.ops import conv_xproj as port_cx
from dimsum_torch.ops import norms as port_norms
from dimsum_torch.transport import Sampler, create_transport
from dimsum_torch.utils.convert import state_dict_from_jax_params
from tests.test_torch_convert import (  # noqa: F401
    PUBLISHED, SMALL, randomize, torch_one_thread)
from tests.test_torch_train import (DROP_IDS, MASKS, _draws, _grads_by_name,
                                    _patch_drop_path, _patch_jax_sample,
                                    fixed_transport)

# the small DiM's switches-off output before the switches existed: SHA-256
# of its float32 bytes, and their sum (to read a mismatch by)
DEFAULT_OUT_SHA256 = ("1fadf159b2c32031a36de915f84b237e"
                      "b6de8a6e70174865cedb93238019b1d5")
DEFAULT_OUT_SUM = 737.4890533231082
ALL_ON = dict(pallas_norm=True, fused_norm=True, conv_xproj=True)
# stochastic depth on blocks 2 and 3 and label dropout, for the training
# test (the forward tests run in eval mode, where neither acts)
TRAIN = dict(drop_path=0.2, label_dropout=0.1)


def _jax_env(monkeypatch, pending_tail):
    monkeypatch.setenv("DIMSUM_NORM_INTERPRET", "1")
    monkeypatch.setenv("DIMSUM_CONV_XPROJ", "1")
    monkeypatch.setenv("DIMSUM_PENDING_TAIL", str(pending_tail))


@pytest.fixture(scope="module")
def jax_small():
    """The JAX small DiM and its randomized params (initialized once, with
    the switches off: the params tree is the same with them on)."""
    jmodel = JaxDiM(JaxDiMConfig(**SMALL, **PUBLISHED, **TRAIN))
    z = jnp.zeros((2, 4, 32, 32))
    params = randomize(jax.jit(jmodel.init)(
        jax.random.PRNGKey(1), z, jnp.zeros((2,)),
        jnp.zeros((2,), jnp.int32)), 1)
    return jmodel, params


def _port(params, pending_tail):
    """The port's small DiM with the JAX weights and every switch on."""
    port = DiM(DiMConfig(**SMALL, **TRAIN, **ALL_ON,
                         pending_tail=pending_tail))
    port.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return port


def _inputs(seed, n=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4, 32, 32)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, n).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, t, y


@pytest.mark.parametrize("pending_tail", [0, 2])
def test_fused_dim_forward_cfg_and_sample_match_jax(pending_tail, jax_small,
                                                    monkeypatch):
    """One compiled JAX forward (the CFG batch of 4) serves the forward,
    the CFG combination and the sample's three drift calls.  The sample's
    Euler loop is the port's `Sampler` driving each model (its time grid
    and steps are held to the JAX `Sampler` in tests/test_torch_dim.py);
    the JAX `Sampler` would compile the whole loop again."""
    _jax_env(monkeypatch, pending_tail)
    jmodel, params = jax_small
    port = _port(params, pending_tail).eval()
    x, t, y = _inputs(0)
    xc = np.concatenate([x, x])
    tc = np.concatenate([t, t])
    yc = np.concatenate([y, np.full(2, 10, np.int32)])
    japply = jax.jit(lambda p, x, t, y: jmodel.apply(p, x, t, y))
    sample = Sampler(create_transport("GVP", "velocity")).sample_ode(
        sampling_method="euler", num_steps=4)
    T = torch.from_numpy

    def jax_drift(x_, t_, y=None):
        # the compiled signature: float32 x and t, int32 labels
        return T(np.array(jax_forward_with_cfg(
            japply, params, x_.numpy(), t_.numpy(),
            y.numpy().astype(np.int32), cfg_scale=1.4)))

    with pltpu.force_tpu_interpret_mode():
        raw = japply(params, xc, tc, yc)
        want = (raw, jax_forward_with_cfg(lambda *a: raw, params, xc, tc, yc,
                                          cfg_scale=1.4),
                sample(T(xc), jax_drift, y=T(yc).long()))

    with torch.no_grad():
        got = (port(T(xc), T(tc), T(yc).long()),
               forward_with_cfg(port, T(xc), T(tc), T(yc).long(),
                                cfg_scale=1.4),
               sample(T(xc), lambda x_, t_, y=None: forward_with_cfg(
                   port, x_, t_, y, cfg_scale=1.4), y=T(yc).long()))
    for name, a, b, tol in zip(("forward", "cfg", "sample"), got, want,
                               (5e-5, 5e-5, 1e-4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("pending_tail", [0, 2])
def test_fused_dim_loss_and_grads_match_jax(pending_tail, jax_small,
                                           monkeypatch):
    """Training mode: label dropout and stochastic depth (blocks 2 and 3,
    where the deferred tail is materialized before the mask), with the
    draws injected; the backward goes through each kernel's custom_vjp in
    JAX and through each Function in the port."""
    _jax_env(monkeypatch, pending_tail)
    jmodel, params = jax_small
    port = _port(params, pending_tail)
    x1, x0, t, y = _draws(2)
    jtr = jax_create_transport("GVP", "velocity")

    def loss_fn(p):
        def model_fn(xt, t_, **mkw):
            return jmodel.apply(p, xt, t_, train=True,
                                rngs={"drop_path": jax.random.PRNGKey(9),
                                      "label_dropout":
                                          jax.random.PRNGKey(9)}, **mkw)
        terms = jtr.training_losses(model_fn, jax.random.PRNGKey(0), x1,
                                    {"y": y, "force_drop_ids": DROP_IDS})
        return terms["loss"].mean()

    with pytest.MonkeyPatch.context() as mp:
        _patch_jax_sample(mp, t, x0)
        jcalls = _patch_drop_path(mp, jax_blocks, MASKS, jnp.asarray)
        with pltpu.force_tpu_interpret_mode():
            want_loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)

    calls = _patch_drop_path(monkeypatch, port_blocks, MASKS,
                             torch.from_numpy)
    port.train()
    tr = fixed_transport(t, x0, force_drop_ids=DROP_IDS)
    loss = tr.training_losses(
        lambda xt, t_, **mkw: port(xt, t_, train=True, **mkw),
        torch.from_numpy(x1), None,
        {"y": torch.from_numpy(y).long()})["loss"].mean()
    loss.backward()

    assert calls == pytest.approx(jcalls) and len(calls) == 2
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = state_dict_from_jax_params(jgrads)
    got = _grads_by_name(port)
    assert set(got) == set(want)
    for name in sorted(want):
        g, w = got[name].numpy(), want[name].numpy()
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= 1e-3 * scale, name


def _count_routes(monkeypatch):
    """Count the calls of each kernel's plain version, which the kernel
    routes take for CPU tensors (and nothing else calls in a forward)."""
    counts = {"add_norm": 0, "norm_modulate": 0, "conv_xproj": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(port_norms, "add_norm_ref",
                        counting("add_norm", port_norms.add_norm_ref))
    monkeypatch.setattr(port_norms, "norm_modulate_ref",
                        counting("norm_modulate",
                                 port_norms.norm_modulate_ref))
    monkeypatch.setattr(port_cx, "conv_xproj_ref",
                        counting("conv_xproj", port_cx.conv_xproj_ref))
    return counts


# depth 8 with the DiT block after blocks 4 and 8; per forward: add + norm
# at each top norm with a residual that no deferred tail reaches, norm +
# modulate at each norm_2, the DiT block's two norms, the FinalLayer's and
# (pending_tail 2, or 1 with fused_norm) every deferred top norm
@pytest.mark.parametrize("switches, want", [
    (dict(), (0, 0, 0)),
    (dict(ALL_ON), (7, 8 + 2 * 2 + 1, 16)),
    (dict(ALL_ON, pending_tail=2), (1, 8 + 6 + 2 * 2 + 1, 16)),
    (dict(ALL_ON, pending_tail=1), (1, 8 + 6 + 2 * 2 + 1, 16)),
    (dict(pallas_norm=True, pending_tail=1), (1, 0, 0)),
    (dict(pending_tail=2), (0, 6, 0)),
    (dict(fused_norm=True), (0, 13, 0)),
    (dict(conv_xproj=True), (0, 0, 16)),
    (dict(ALL_ON, hidden_size=64), (0, 0, 0)),  # every gate refuses D 64
])
def test_sites_take_the_kernels_the_jax_gates_pick(switches, want,
                                                   monkeypatch):
    counts = _count_routes(monkeypatch)
    cfg = DiMConfig(**{**SMALL, "depth": 8, "img_resolution": 16,
                       **switches})
    model = build_dim(cfg, "cpu", seed=0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 4, 16, 16))
                         .astype(np.float32))
    with torch.no_grad():
        model(x, torch.tensor([0.3, 0.7]), torch.tensor([1, 2]))
    assert (counts["add_norm"], counts["norm_modulate"],
            counts["conv_xproj"]) == want


def test_switches_off_output_unchanged_bit_for_bit():
    cfg = DiMConfig(**SMALL)
    assert not (cfg.pallas_norm or cfg.fused_norm or cfg.conv_xproj
                or cfg.pending_tail)
    model = build_dim(cfg, "cpu", seed=0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 32, 32)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, 2).astype(np.float32)
    y = rng.integers(0, 10, 2)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(y).long())
    got = out.numpy()
    assert got.dtype == np.float32 and got.shape == (2, 4, 32, 32)
    digest = hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest()
    assert digest == DEFAULT_OUT_SHA256, (
        f"output changed: sum {got.astype(np.float64).sum()!r}, "
        f"was {DEFAULT_OUT_SUM!r}")


def test_pending_tail_alone_is_exact_in_fp32():
    """Mode 1 without the kernels defers the tail into the next top norm's
    composition: the same fp32 ops in the same order (the JAX
    `test_pending_tail_xla_exact`)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 4, 32, 32))
                         .astype(np.float32))
    t, y = torch.tensor([0.2, 0.6]), torch.tensor([3, 4])
    outs = []
    for pending_tail in (0, 1):
        model = build_dim(DiMConfig(**SMALL, pending_tail=pending_tail),
                          "cpu", seed=2)
        with torch.no_grad():
            outs.append(model(x, t, y))
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)


def test_pending_tail_must_be_a_known_mode():
    with pytest.raises(ValueError, match="pending_tail"):
        DiM(DiMConfig(**SMALL, pending_tail=3))
