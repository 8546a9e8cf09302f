"""The port's transport (`dimsum_torch/transport`) against the JAX
package's, on the same numpy inputs:

  * `ode_dopri5` on analytic drifts, autonomous and time-dependent, with
    and without `first_dt`: x(t1) within 1e-5 relative, the NFE equal;
  * dopri5 sampling of the tiny DiM (`test_model_torch_parity.py::
    make_model_sd`, fp32, CFG 1.4, loaded into JAX through
    `convert_torch_state_dict(strict=True)`): samples within 1e-4, the NFE
    equal (on a mismatch the test names the step where the two runs part
    and how far the port's error norm was from 1.0 there);
  * the SDE samplers (Euler-Maruyama, Heun) with JAX's normal draws
    injected, over the velocity, score and noise models, the Linear, GVP
    and VP plans, every diffusion form and every last step, with an
    analytic model: within 1e-5 (relative to each output's scale);
  * the plans (alpha, sigma, drift, diffusion, the score / noise /
    velocity conversions) on a grid of t, the drifts and scores,
    `check_interval`, and the noise and score training losses: 1e-6
    relative (elementwise fp32, the same formulas);
  * the ODE likelihood of the tiny DiM with JAX's Rademacher probe
    injected (the plain scan; `torch.autograd.grad` against `jax.vjp`):
    log p within 1e-4 relative;
  * `forward_with_adacfg` on the tiny DiM: 5e-5, as the CFG forward.

The tiny DiM's fp32 forward differs from JAX's by ~1e-6 relative (the JAX
associative scan against the port's sequential one); dopri5's decisions
could flip only on an error norm within that of 1.0."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dimsum_tpu.models.dim import DiM as JaxDiM
from dimsum_tpu.models.dim import DiMConfig as JaxDiMConfig
from dimsum_tpu.models.dim import forward_with_adacfg as jax_adacfg
from dimsum_tpu.models.dim import forward_with_cfg as jax_cfg
from dimsum_tpu.transport import Sampler as JaxSampler
from dimsum_tpu.transport import create_transport as jax_create_transport
from dimsum_tpu.transport import integrators as jax_int
from dimsum_tpu.utils.ckpt import convert_torch_state_dict
from dimsum_torch.models.dim import DiM, DiMConfig, forward_with_adacfg
from dimsum_torch.models.dim import forward_with_cfg
from dimsum_torch.transport import Sampler, create_transport
from dimsum_torch.transport import integrators
from tests.test_model_torch_parity import make_model_sd
from tests.test_torch_convert import torch_one_thread  # noqa: F401

# the tiny DiM of make_model_sd: hidden 32, depth 2, grid 8 (latent 16),
# the shared DiT block after the 2nd block, 10 classes and a null row
TINY = dict(img_resolution=16, patch_size=2, hidden_size=32, depth=2,
            num_classes=10, label_dropout=0.1, use_attn_every_k_layers=2)
JAX_PUBLISHED = dict(rms_norm=True, block_type="combined", cond_mamba=True,
                     learnable_pe=True, scan_impl="xla")


def tiny_state_dict(seed):
    """A reference-format state dict of the tiny DiM (numpy arrays)."""
    return make_model_sd(np.random.default_rng(seed))


def tiny_jax(sd):
    """(JAX model, params converted strictly from `sd`)."""
    jmodel = JaxDiM(JaxDiMConfig(**TINY, **JAX_PUBLISHED))
    template = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 4, 16, 16)),
        jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))["params"]
    return jmodel, convert_torch_state_dict(sd, template, strict=True)


def tiny_port(sd, dtype=torch.float32):
    port = DiM(DiMConfig(**TINY, dtype=dtype))
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                         strict=True)
    return port.eval()


@pytest.fixture(scope="module")
def tiny():
    sd = tiny_state_dict(11)
    jmodel, params = tiny_jax(sd)
    return jmodel, params, tiny_port(sd)


def _cfg_batch(seed, n=2):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, 4, 16, 16)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return (np.concatenate([z, z]),
            np.concatenate([y, np.full(n, 10, np.int32)]))


# --------------------------------------------------------------------------
# dopri5
# --------------------------------------------------------------------------

def _drift_pair(kind):
    """The same drift in JAX and in PyTorch: dx/dt(x, t_vec).  Both move
    fast enough that every step's error estimate stands far above the fp32
    rounding of x: where it does not (a drift so smooth that x5 - x4 is a
    few ulp), the controller's next step is decided by rounding, which
    XLA's fused arithmetic and PyTorch's eager ops do not share."""
    if kind == "autonomous":  # a nonlinear oscillator on (u, v) = x[:, 0:2]
        def jd(x, t):
            u, v = x[:, :1], x[:, 1:]
            return jnp.concatenate([8 * v, -8 * u - 2 * jnp.sin(u)], 1)

        def pd(x, t):
            u, v = x[:, :1], x[:, 1:]
            return torch.cat([8 * v, -8 * u - 2 * torch.sin(u)], 1)
        return jd, pd

    def jd(x, t):
        te = t.reshape(-1, 1, 1)
        return 3 * jnp.cos(8 * te) * x + jnp.sin(10 * te) - 0.5 * jnp.tanh(x)

    def pd(x, t):
        te = t.reshape(-1, 1, 1)
        return 3 * torch.cos(8 * te) * x + torch.sin(10 * te) \
            - 0.5 * torch.tanh(x)
    return jd, pd


class _Trace:
    """The drift-call times of a dopri5 run and, on the port's side, each
    attempted step's error norm."""

    def __init__(self):
        self.times, self.norms = [], []


def _port_dopri5(drift, x, t0, t1, trace, monkeypatch, **kw):
    calls = []
    rms = integrators._rms
    monkeypatch.setattr(integrators, "_rms",
                        lambda v: calls.append(rms(v)) or calls[-1])

    def traced(x_, t_):
        trace.times.append(float(t_[0]))
        return drift(x_, t_)

    out = integrators.ode_dopri5(traced, x, t0, t1, return_nfe=True, **kw)
    # the first three norms choose the initial step (without first_dt)
    skip = 0 if kw.get("first_dt") is not None else 3
    trace.norms = [float(v) for v in calls[skip:]]
    return out


def _jax_dopri5(drift, x, t0, t1, trace, **kw):
    def traced(x_, t_):
        jax.debug.callback(lambda t: trace.times.append(float(t[0])), t_,
                           ordered=True)
        return drift(x_, t_)

    x_out, nfe = jax.jit(lambda x: jax_int.ode_dopri5(
        traced, x, t0, t1, return_nfe=True, **kw))(x)
    return np.asarray(x_out), int(nfe)


def _nfe_report(port, want, nfe, jnfe):
    """Where the two runs part: the first drift call at another time, its
    attempted step, and the port's error norm there against 1.0."""
    k = next((i for i, (a, b) in enumerate(zip(port.times, want.times))
              if a != b), min(len(port.times), len(want.times)))
    step = max(0, (k - 2) // 6)
    norm = port.norms[step] if step < len(port.norms) else float("nan")
    return (f"NFE port {nfe} != JAX {jnfe}: the drift calls part at call "
            f"{k} (attempted step {step}), where the port's error norm was "
            f"{norm!r}, {abs(norm - 1.0):.3e} from 1.0")


@pytest.mark.parametrize("rtol", [1e-3, 1e-4])
@pytest.mark.parametrize("first_dt", [None, 0.05])
@pytest.mark.parametrize("kind", ["autonomous", "time-dependent"])
def test_dopri5_analytic_drift_matches_jax(monkeypatch, kind, first_dt,
                                           rtol):
    jd, pd = _drift_pair(kind)
    x = np.random.default_rng(1).standard_normal((3, 2, 5)).astype(
        np.float32)
    kw = dict(rtol=rtol, atol=1e-6, first_dt=first_dt)
    jt, pt = _Trace(), _Trace()
    want, jnfe = _jax_dopri5(jd, jnp.asarray(x), 0.0, 1.0, jt, **kw)
    got, nfe = _port_dopri5(pd, torch.from_numpy(x), 0.0, 1.0, pt,
                            monkeypatch, **kw)
    assert nfe == jnfe, _nfe_report(pt, jt, nfe, jnfe)
    # one drift call more than the NFE without first_dt: the initial probe
    assert len(pt.times) == nfe + (first_dt is None)
    assert nfe > 13  # more than two steps
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_dopri5_keeps_x_on_a_rejected_step():
    """A first step far too large is rejected: t stays, x stays, and the
    NFE counts it; the result still reaches t1."""
    jd, pd = _drift_pair("time-dependent")
    x = np.random.default_rng(2).standard_normal((2, 3, 3)).astype(
        np.float32)
    want, jnfe = _jax_dopri5(jd, jnp.asarray(x), 0.0, 1.0, _Trace(),
                             first_dt=1.0, rtol=1e-6, atol=1e-8)
    times = []
    got, nfe = integrators.ode_dopri5(
        lambda x_, t_: times.append(float(t_[0])) or pd(x_, t_),
        torch.from_numpy(x), 0.0, 1.0, first_dt=1.0, rtol=1e-6, atol=1e-8,
        return_nfe=True)
    assert nfe == jnfe
    # the second attempt starts again at t0 = 0 with a shorter step
    assert times[1] == pytest.approx(0.2) and times[7] < 0.2
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_dopri5_stops_at_max_steps():
    _, pd = _drift_pair("autonomous")
    x = torch.ones(2, 2, 2)
    _, nfe = integrators.ode_dopri5(pd, x, 0.0, 1.0, first_dt=1e-6,
                                    max_steps=3, return_nfe=True)
    assert nfe == 1 + 6 * 3


def test_tiny_dim_dopri5_sample_matches_jax(monkeypatch, tiny):
    """GVP velocity, CFG 1.4, the sampler's default tolerances."""
    jmodel, params, port = tiny
    z, y = _cfg_batch(3)
    jt, pt = _Trace(), _Trace()

    def jfn(x, t, y=None):
        jax.debug.callback(lambda tt: jt.times.append(float(tt[0])), t,
                           ordered=True)
        return jax_cfg(jmodel.apply, {"params": params}, x, t, y,
                       cfg_scale=1.4)

    jsample = JaxSampler(jax_create_transport("GVP", "velocity")).sample_ode(
        sampling_method="dopri5", return_nfe=True)
    want, jnfe = jax.jit(lambda z, y: jsample(z, jfn, y=y))(z, y)
    want, jnfe = np.asarray(want), int(jnfe)

    rms = integrators._rms
    norms = []
    monkeypatch.setattr(integrators, "_rms",
                        lambda v: norms.append(rms(v)) or norms[-1])

    def pfn(x, t, y=None):
        pt.times.append(float(t[0]))
        return forward_with_cfg(port, x, t, y, cfg_scale=1.4)

    sample = Sampler(create_transport("GVP", "velocity")).sample_ode(
        sampling_method="dopri5", return_nfe=True)
    with torch.no_grad():
        got, nfe = sample(torch.from_numpy(z), pfn,
                          y=torch.from_numpy(y).long())
    pt.norms = [float(v) for v in norms[3:]]
    assert nfe == jnfe, _nfe_report(pt, jt, nfe, jnfe)
    assert nfe > 13
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# plans, drifts, scores, intervals, losses
# --------------------------------------------------------------------------

PATHS = ["Linear", "GVP", "VP"]
MODELS = ["velocity", "score", "noise"]
FORMS = ["none", "constant", "SBDM", "sigma", "linear", "decreasing",
         "increasing-decreasing", "log"]


def _pair(path, prediction, **kw):
    return (jax_create_transport(path, prediction, **kw),
            create_transport(path, prediction, **kw))


def _close(got, want, rtol=1e-6, atol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("path", PATHS)
def test_plan_functions_match_jax(path):
    jt, pt = _pair(path, "velocity")
    jp, pp = jt.path_sampler, pt.path_sampler
    rng = np.random.default_rng(4)
    t = np.linspace(0.02, 0.98, 7).astype(np.float32)
    x = rng.standard_normal((7, 3, 2, 2)).astype(np.float32)
    v = rng.standard_normal((7, 3, 2, 2)).astype(np.float32)
    tt, xt, vt = map(torch.from_numpy, (t, x, v))
    te, tte = t.reshape(-1, 1, 1, 1), tt.reshape(-1, 1, 1, 1)
    for name in ("compute_alpha_t", "compute_sigma_t"):
        for a, b in zip(getattr(pp, name)(tte), getattr(jp, name)(te)):
            _close(a, b)
    _close(pp.compute_d_alpha_alpha_ratio_t(tte),
           jp.compute_d_alpha_alpha_ratio_t(te))
    for a, b in zip(pp.compute_drift(xt, tt), jp.compute_drift(x, t)):
        _close(a * torch.ones_like(xt), b * jnp.ones_like(x))
    for form in FORMS:
        _close(pp.compute_diffusion(xt, tt, form=form, norm=0.7),
               jp.compute_diffusion(x, t, form=form, norm=0.7))
    for name in ("get_score_from_velocity", "get_noise_from_velocity",
                 "get_velocity_from_score"):
        _close(getattr(pp, name)(vt, xt, tt), getattr(jp, name)(v, x, t),
               rtol=1e-5, atol=1e-5)
    for a, b in zip(pp.plan(tt, xt, vt), jp.plan(t, x, v)):
        _close(a, b)


def test_vp_plan_and_blurring():
    from dimsum_torch.transport import VPCPlan

    jt, pt = _pair("VP", "velocity", path_args={"sigma_min": 0.2,
                                                "sigma_max": 10.0})
    assert isinstance(pt.path_sampler, VPCPlan)
    assert pt.path_sampler.sigma_max == 10.0
    t = np.linspace(0.1, 0.9, 5).astype(np.float32)
    _close(pt.path_sampler.compute_sigma_t(torch.from_numpy(t))[0],
           jt.path_sampler.compute_sigma_t(t)[0])
    # the DCT-blurred interpolant: x_t against the JAX plan's
    jt, pt = _pair("GVP", "velocity", path_args={"use_blurring": True})
    rng = np.random.default_rng(6)
    x0, x1 = (rng.standard_normal((5, 4, 8, 8)).astype(np.float32)
              for _ in range(2))
    _close(pt.path_sampler.compute_xt(torch.from_numpy(t),
                                      torch.from_numpy(x0),
                                      torch.from_numpy(x1)),
           jt.path_sampler.compute_xt(t, x0, x1))


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("prediction", MODELS)
def test_drift_and_score_match_jax(path, prediction):
    jt, pt = _pair(path, prediction)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((5, 2, 3, 3)).astype(np.float32)
    t = np.linspace(0.05, 0.95, 5).astype(np.float32)

    def jfn(x_, t_):
        return 0.5 * jnp.tanh(x_) + t_.reshape(-1, 1, 1, 1)

    def pfn(x_, t_):
        return 0.5 * torch.tanh(x_) + t_.reshape(-1, 1, 1, 1)

    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    _close(pt.get_drift()(xt, tt, pfn), jt.get_drift()(x, t, jfn),
           rtol=1e-5, atol=1e-5)
    _close(pt.get_score()(xt, tt, pfn), jt.get_score()(x, t, jfn),
           rtol=1e-5, atol=1e-5)
    _close(pt.prior_logp(xt), jt.prior_logp(x), rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("path, prediction, kw", [
    ("VP", "velocity", dict(sde=False)),
    ("VP", "velocity", dict(sde=True, last_step_size=0.04)),
    ("VP", "noise", dict(sde=True, last_step_size=0.0, reverse=True)),
    ("GVP", "velocity", dict(sde=True, diffusion_form="SBDM")),
    ("GVP", "velocity", dict(sde=True, diffusion_form="sigma",
                             last_step_size=0.04)),
    ("Linear", "score", dict(sde=False, reverse=True)),
    ("Linear", "velocity", dict(sde=False)),
    ("GVP", "noise", dict(sde=True, diffusion_form="linear")),
])
@pytest.mark.parametrize("evaluating", [False, True])
def test_check_interval_matches_jax(path, prediction, kw, evaluating):
    jt, pt = _pair(path, prediction)
    assert (pt.train_eps, pt.sample_eps) == (jt.train_eps, jt.sample_eps)
    want = jt.check_interval(jt.train_eps, jt.sample_eps, eval=evaluating,
                             **kw)
    got = pt.check_interval(pt.train_eps, pt.sample_eps, eval=evaluating,
                            **kw)
    assert got == pytest.approx(want, rel=0, abs=0)


@pytest.mark.parametrize("weight", [None, "velocity", "likelihood"])
@pytest.mark.parametrize("prediction", ["noise", "score"])
@pytest.mark.parametrize("path", PATHS)
def test_noise_and_score_losses_match_jax(monkeypatch, path, prediction,
                                          weight):
    from dimsum_tpu.transport.transport import Transport as JaxTransport
    from dimsum_torch.transport.transport import Transport

    rng = np.random.default_rng(6)
    x1 = rng.standard_normal((4, 2, 3, 3)).astype(np.float32)
    x0 = rng.standard_normal((4, 2, 3, 3)).astype(np.float32)
    t = np.array([0.1, 0.4, 0.6, 0.9], np.float32)
    monkeypatch.setattr(JaxTransport, "sample",
                        lambda self, rng_, x: (jnp.asarray(t),
                                               jnp.asarray(x0), x))
    monkeypatch.setattr(Transport, "sample",
                        lambda self, x, generator=None: (
                            torch.from_numpy(t), torch.from_numpy(x0), x))
    jt, pt = _pair(path, prediction, loss_weight=weight)
    want = jt.training_losses(lambda x, t_: 0.3 * x - t_.reshape(-1, 1, 1, 1),
                              jax.random.PRNGKey(0), jnp.asarray(x1))
    got = pt.training_losses(
        lambda x, t_: 0.3 * x - t_.reshape(-1, 1, 1, 1), torch.from_numpy(x1))
    _close(got["loss"], want["loss"], rtol=1e-5, atol=1e-6)
    assert got["loss"].shape == (4,)


# --------------------------------------------------------------------------
# SDE samplers, JAX's draws injected
# --------------------------------------------------------------------------

def _jax_normals(key, shape, n):
    """The draws the JAX steppers take: key, sub = split(key) per step."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return out


LASTS = [None, "Mean", "Tweedie", "Euler"]
SDE_CASES = [(model, path, method)
             for model in MODELS for path in PATHS
             for method in ("Euler", "Heun")]


@pytest.mark.parametrize("index", range(len(SDE_CASES)),
                         ids=["-".join(c) for c in SDE_CASES])
def test_sde_sampler_matches_jax(index):
    """Each (model, plan, stepper) case takes the next diffusion form and
    last step in turn, so every form and every last step runs with both
    steppers.  sample_eps 0.01 keeps every form finite at the ends."""
    model, path, method = SDE_CASES[index]
    form, last = FORMS[index % len(FORMS)], LASTS[index % len(LASTS)]
    jt, pt = _pair(path, model, sample_eps=0.01)
    kw = dict(sampling_method=method, diffusion_form=form,
              diffusion_norm=0.8, last_step=last, last_step_size=0.05,
              num_steps=10)
    x = np.random.default_rng(index).standard_normal((3, 2, 4, 4)).astype(
        np.float32)
    key = jax.random.PRNGKey(index)

    def jfn(x_, t_):
        return 0.4 * jnp.tanh(x_) - 0.2 * t_.reshape(-1, 1, 1, 1) * x_

    def pfn(x_, t_):
        return 0.4 * torch.tanh(x_) - 0.2 * t_.reshape(-1, 1, 1, 1) * x_

    # op by op: a compile per case would take most of the test's time
    with jax.disable_jit():
        want = np.asarray(JaxSampler(jt).sample_sde(**kw)(x, jfn, key))
    steps = 10 if method == "Euler" else 5
    draws = _jax_normals(key, x.shape, steps - 1)
    got = Sampler(pt).sample_sde(**kw)(
        torch.from_numpy(x), pfn,
        draw=lambda shape: torch.tensor(draws.pop(0)))
    assert not draws  # one draw per step, all taken
    assert np.isfinite(want).all()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * scale)


def test_sde_default_draws_come_from_the_generator():
    pt = create_transport("GVP", "velocity")
    sample = Sampler(pt).sample_sde(diffusion_form="sigma", num_steps=5)
    x = torch.zeros(2, 1, 2, 2)

    def fn(x_, t_):
        return -x_

    a = sample(x, fn, generator=torch.Generator().manual_seed(3))
    b = sample(x, fn, generator=torch.Generator().manual_seed(3))
    c = sample(x, fn, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)


# --------------------------------------------------------------------------
# the tiny DiM: likelihood and adaptive CFG
# --------------------------------------------------------------------------

def test_tiny_dim_likelihood_matches_jax(tiny):
    """cfg 1.0 (the plain model), 5 grid points, the JAX sampler's probe
    vector (Rademacher from PRNGKey(7)) injected into the port."""
    jmodel, params, port = tiny
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    y = rng.integers(0, 10, 2).astype(np.int32)
    key = jax.random.PRNGKey(7)
    jlik = JaxSampler(jax_create_transport("GVP", "velocity")) \
        .sample_ode_likelihood(num_steps=5)
    want_logp, want_x = jax.jit(lambda x, y: jlik(
        x, lambda x_, t_, y=None: jmodel.apply({"params": params}, x_, t_,
                                               y), key, y=y))(x, y)
    eps = np.asarray(jax.random.rademacher(key, x.shape, jnp.float32))

    lik = Sampler(create_transport("GVP", "velocity")).sample_ode_likelihood(
        num_steps=5)
    got_logp, got_x = lik(torch.from_numpy(x), port,
                          eps=torch.tensor(eps),
                          y=torch.from_numpy(y).long())
    assert not got_logp.requires_grad and got_logp.shape == (2,)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_logp.numpy(), np.asarray(want_logp),
                               rtol=1e-4)
    # a different probe gives a different estimate
    other, _ = lik(torch.from_numpy(x), port,
                   generator=torch.Generator().manual_seed(1),
                   y=torch.from_numpy(y).long())
    assert not torch.allclose(other, got_logp)


def test_forward_with_adacfg_matches_jax(tiny):
    jmodel, params, port = tiny
    z, y = _cfg_batch(9)
    t = np.array([0.2, 0.7, 0.2, 0.7], np.float32)
    want = jax.jit(lambda z, t, y: jax_adacfg(
        jmodel.apply, {"params": params}, z, t, y, cfg_scale=3.0))(z, t, y)
    with torch.no_grad():
        got = forward_with_adacfg(port, torch.from_numpy(z),
                                  torch.from_numpy(t),
                                  torch.from_numpy(y).long(), cfg_scale=3.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)
    # the scale moves with t: not plain CFG at the same nominal scale
    with torch.no_grad():
        plain = forward_with_cfg(port, torch.from_numpy(z),
                                 torch.from_numpy(t),
                                 torch.from_numpy(y).long(), cfg_scale=3.0)
    assert not torch.allclose(got, plain)


def test_dopri5_reverse_matches_jax(tiny):
    """`reverse=True` integrates the drift at 1 - t; fixed-step Euler here
    so the two runs take the same grid."""
    jmodel, params, port = tiny
    z, y = _cfg_batch(10)
    kw = dict(sampling_method="euler", num_steps=3, reverse=True)
    jsample = JaxSampler(jax_create_transport("GVP", "velocity")).sample_ode(
        **kw)
    want = jax.jit(lambda z, y: jsample(z, lambda x, t, y=None: jax_cfg(
        jmodel.apply, {"params": params}, x, t, y, cfg_scale=1.4),
        y=y))(z, y)
    sample = Sampler(create_transport("GVP", "velocity")).sample_ode(**kw)
    with torch.no_grad():
        got = sample(torch.from_numpy(z), lambda x, t, y=None:
                     forward_with_cfg(port, x, t, y, cfg_scale=1.4),
                     y=torch.from_numpy(y).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_bench_dopri5_reports_the_nfe():
    from dimsum_torch import bench

    record, samples = bench.run(batch=1, dtype="fp32", device="cpu",
                                model="DiM-S/2", solver="dopri5")
    assert record["solver"] == "dopri5" and record["nfe"] >= 13
    assert (record["nfe"] - 1) % 6 == 0
    assert torch.isfinite(samples).all()
    assert "dopri5" in record["metric"]

