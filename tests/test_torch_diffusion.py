"""The ADM Gaussian diffusion (dimsum_torch/diffusion/) against the JAX
package's (dimsum_tpu/diffusion/), on the cases of tests/test_diffusion.py,
as values: the schedule tables, q_sample, the eps / x_0 conversions, the
posterior, p_mean_variance for every variance and mean type, the DDPM and
DDIM loops with JAX's draws fed in, the training losses of every loss
type (JAX's noise fed in), respacing, the timestep samplers and
`create_diffusion`.  Models are fixed functions of (x, t), the same in
both packages.

Tolerances: the tables are the same float64 numpy code, so equal; the
tensors are fp32 elementwise arithmetic in another framework, 1e-5
relative and 1e-6 absolute (the losses through log / erfc: 1e-4
relative)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import dimsum_tpu.diffusion as jd
import dimsum_torch.diffusion as td
from tests.test_torch_convert import torch_one_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)
TABLES = ("betas", "alphas_cumprod", "alphas_cumprod_prev",
          "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
          "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
          "posterior_variance", "posterior_log_variance_clipped",
          "posterior_mean_coef1", "posterior_mean_coef2")
MEANS = ("EPSILON", "START_X")
VARS = ("FIXED_SMALL", "FIXED_LARGE", "LEARNED", "LEARNED_RANGE")


def pair(schedule="linear", steps=100, mean="EPSILON", var="FIXED_SMALL",
         loss="MSE"):
    betas = td.get_named_beta_schedule(schedule, steps)
    np.testing.assert_array_equal(
        betas, jd.get_named_beta_schedule(schedule, steps))
    kw = lambda m: dict(model_mean_type=getattr(m.ModelMeanType, mean),
                        model_var_type=getattr(m.ModelVarType, var),
                        loss_type=getattr(m.LossType, loss))
    return (jd.GaussianDiffusion(betas=betas, **kw(jd)),
            td.GaussianDiffusion(betas=betas, **kw(td)))


def _np(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def model_pair(learned: bool):
    """The same model in both packages: 0.3 x + 0.01 t, and with a learned
    variance tanh(x) on the channels after it."""
    def jax_fn(x, t, **kw):
        out = 0.3 * x + 0.01 * t[:, None, None, None].astype(x.dtype)
        return jnp.concatenate([out, jnp.tanh(x)], 1) if learned else out

    def port_fn(x, t, **kw):
        out = 0.3 * x + 0.01 * t[:, None, None, None].to(x.dtype)
        return torch.cat([out, torch.tanh(x)], 1) if learned else out

    return jax_fn, port_fn


@pytest.mark.parametrize("schedule, steps", [("linear", 1000),
                                             ("cosine", 100),
                                             ("linear", 10)])
def test_schedule_tables_equal_jax(schedule, steps):
    jgd, tgd = pair(schedule, steps)
    for name in TABLES:
        np.testing.assert_array_equal(getattr(tgd, name),
                                      getattr(jgd, name), err_msg=name)


def test_q_sample_and_posterior_match_jax():
    jgd, tgd = pair()
    x0, noise = _np(0, (4, 3, 4, 4)), _np(1, (4, 3, 4, 4))
    t = np.array([0, 10, 50, 99])
    tt = torch.from_numpy(t)
    xt = tgd.q_sample(torch.from_numpy(x0), tt, torch.from_numpy(noise))
    _close(xt, jgd.q_sample(x0, jnp.asarray(t), noise))
    got = tgd.q_posterior_mean_variance(torch.from_numpy(x0), xt, tt)
    want = jgd.q_posterior_mean_variance(x0, np.asarray(xt), jnp.asarray(t))
    for a, b in zip(got, want):
        _close(a, b)
    # t = 0 leaves x_start nearly as it is
    _close(tgd.q_sample(torch.ones(2, 3, 4, 4), torch.zeros(2).long(),
                        torch.zeros(2, 3, 4, 4)),
           np.ones((2, 3, 4, 4)), dict(rtol=1e-3))


def test_eps_xstart_conversions_match_jax():
    jgd, tgd = pair()
    x0, eps = _np(2, (2, 3, 4, 4)), _np(3, (2, 3, 4, 4))
    t = np.array([10, 50])
    tt = torch.from_numpy(t)
    xt = tgd.q_sample(torch.from_numpy(x0), tt, torch.from_numpy(eps))
    got = tgd._predict_xstart_from_eps(xt, tt, torch.from_numpy(eps))
    _close(got, jgd._predict_xstart_from_eps(np.asarray(xt), t, eps))
    _close(got, x0, dict(rtol=1e-3, atol=1e-3))
    got = tgd._predict_eps_from_xstart(xt, tt, torch.from_numpy(x0))
    _close(got, jgd._predict_eps_from_xstart(np.asarray(xt), t, x0))


@pytest.mark.parametrize("mean", MEANS)
@pytest.mark.parametrize("var", VARS)
@pytest.mark.parametrize("clip", [True, False])
def test_p_mean_variance_matches_jax(mean, var, clip):
    jgd, tgd = pair("cosine", 10, mean, var)
    learned = var.startswith("LEARNED")
    jfn, tfn = model_pair(learned)
    x = _np(4, (3, 3, 4, 4))
    t = np.array([0, 5, 9])
    got = tgd.p_mean_variance(tfn, torch.from_numpy(x), torch.from_numpy(t),
                              clip_denoised=clip)
    want = jgd.p_mean_variance(jfn, jnp.asarray(x), jnp.asarray(t),
                               clip_denoised=clip)
    for k in ("mean", "variance", "log_variance", "pred_xstart"):
        assert torch.isfinite(got[k]).all(), k
        _close(got[k], want[k])


def test_p_mean_variance_of_a_degenerate_schedule_matches_jax():
    """linear over 10 steps scales beta past 1 (the cumulative product
    through 0): the same inf / nan entries as JAX, and a finite learned
    log-variance (tests/test_diffusion.py's case)."""
    jgd, tgd = pair("linear", 10, "EPSILON", "LEARNED_RANGE")
    for name in TABLES:
        np.testing.assert_array_equal(getattr(tgd, name),
                                      getattr(jgd, name), err_msg=name)
    jfn, tfn = model_pair(True)
    x = _np(9, (2, 3, 4, 4))
    t = np.array([5, 9])
    got = tgd.p_mean_variance(tfn, torch.from_numpy(x), torch.from_numpy(t))
    want = jgd.p_mean_variance(jfn, jnp.asarray(x), jnp.asarray(t))
    assert torch.isfinite(got["log_variance"]).all()
    for k in ("mean", "variance", "log_variance", "pred_xstart"):
        _close(got[k], want[k])


@pytest.mark.parametrize("loop", ["p_sample_loop", "ddim_sample_loop"])
@pytest.mark.parametrize("var", ["FIXED_LARGE", "LEARNED_RANGE"])
def test_sampling_loops_match_jax_with_its_draws(loop, var):
    """The whole loop (cosine, 8 steps) from JAX's key: x_T and every
    step's noise drawn as JAX draws them, handed to the port in order."""
    jgd, tgd = pair("cosine", 8, var=var)
    jfn, tfn = model_pair(var == "LEARNED_RANGE")
    shape = (2, 3, 4, 4)
    rng = jax.random.PRNGKey(0)
    extra = dict(eta=0.5) if loop == "ddim_sample_loop" else {}
    want = getattr(jgd, loop)(jfn, shape, rng, **extra)
    key, k0 = jax.random.split(rng)
    draws = [np.asarray(jax.random.normal(k0, shape))]
    for _ in range(tgd.num_timesteps):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(sub, shape)))
    it = iter(draws)
    got = getattr(tgd, loop)(tfn, shape, draw=lambda s: torch.from_numpy(
        next(it)), device="cpu", **extra)
    assert next(it, None) is None
    _close(got, want, dict(rtol=1e-5, atol=1e-5))


def test_sampling_loops_draw_from_their_generator():
    _, tgd = pair("cosine", 8)
    _, tfn = model_pair(False)

    def run(loop, seed):
        return getattr(tgd, loop)(tfn, (2, 3, 4, 4),
                                  generator=torch.Generator().manual_seed(
                                      seed), device="cpu")

    for loop in ("p_sample_loop", "ddim_sample_loop"):
        a = run(loop, 1)
        assert torch.isfinite(a).all() and a.shape == (2, 3, 4, 4)
        assert torch.equal(a, run(loop, 1))
        assert not torch.equal(a, run(loop, 2))


@pytest.mark.parametrize("entry", ["p_sample_loop", "ddim_sample_loop",
                                   "UniformSampler",
                                   "LossSecondMomentResampler"])
def test_sampling_entry_points_default_to_the_card(entry):
    """Without `device` the loops and the timestep samplers run on the
    card: with none present they refuse rather than drop to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, tgd = pair("cosine", 8)
    _, tfn = model_pair(False)
    if entry.endswith("loop"):
        def call():
            getattr(tgd, entry)(tfn, (2, 3, 4, 4))
    else:
        def call():
            getattr(td, entry)(tgd).sample(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


@pytest.mark.parametrize("mean, var, loss", [
    ("EPSILON", "FIXED_SMALL", "MSE"), ("START_X", "FIXED_LARGE", "MSE"),
    ("EPSILON", "LEARNED_RANGE", "MSE"), ("EPSILON", "LEARNED", "MSE"),
    ("EPSILON", "LEARNED_RANGE", "RESCALED_MSE"),
    ("EPSILON", "FIXED_SMALL", "KL"), ("START_X", "LEARNED_RANGE", "KL")])
def test_training_losses_match_jax(mean, var, loss):
    """Every term, with JAX's noise; t = 0 takes the decoder NLL."""
    jgd, tgd = pair("linear", 100, mean, var, loss)
    jfn, tfn = model_pair(var.startswith("LEARNED"))
    x0 = np.clip(_np(5, (4, 3, 4, 4)), -1, 1)
    t = np.array([0, 20, 50, 90])
    rng = jax.random.PRNGKey(3)
    want = jgd.training_losses(jfn, x0, jnp.asarray(t), rng)
    noise = np.asarray(jax.random.normal(rng, x0.shape, x0.dtype))
    got = tgd.training_losses(tfn, torch.from_numpy(x0), torch.from_numpy(t),
                              noise=torch.from_numpy(noise))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], dict(rtol=1e-4, atol=1e-5))


def test_training_losses_zero_for_the_noise_itself():
    _, tgd = pair()
    x0 = torch.from_numpy(_np(6, (4, 3, 4, 4)))
    noise = torch.from_numpy(_np(7, (4, 3, 4, 4)))
    terms = tgd.training_losses(lambda x, t, **kw: noise, x0,
                                torch.tensor([3, 20, 50, 90]), noise=noise)
    assert torch.equal(terms["loss"], torch.zeros(4))


def test_learned_variance_takes_a_gradient_through_the_vb_term_only():
    """The vb term sees the mean detached (ADM's frozen mean): its
    gradient reaches the variance channels alone."""
    _, tgd = pair("cosine", 10, "EPSILON", "LEARNED_RANGE")
    out = torch.zeros(2, 6, 4, 4, requires_grad=True)
    terms = tgd.training_losses(lambda x, t, **kw: out,
                                torch.from_numpy(np.clip(_np(8, (2, 3, 4, 4)),
                                                         -1, 1)),
                                torch.tensor([1, 5]),
                                noise=torch.zeros(2, 3, 4, 4))
    (g,) = torch.autograd.grad(terms["vb"].sum(), out)
    assert not g[:, :3].any() and g[:, 3:].abs().sum() > 0


@pytest.mark.parametrize("spec", ["ddim10", "10", "25,15", "ddim25"])
def test_respacing_matches_jax(spec):
    want = jd.space_timesteps(100, spec)
    assert td.space_timesteps(100, spec) == want
    base = td.get_named_beta_schedule("linear", 100)
    tgd = td.spaced_diffusion(base, want)
    jgd = jd.spaced_diffusion(base, want)
    assert tgd.num_timesteps == len(set(want))
    for name in TABLES:
        np.testing.assert_array_equal(getattr(tgd, name),
                                      getattr(jgd, name), err_msg=name)
    np.testing.assert_allclose(tgd.alphas_cumprod,
                               np.cumprod(1 - base)[sorted(want)],
                               rtol=1e-10)
    with pytest.raises(ValueError):
        td.space_timesteps(100, "ddim30")


def test_timestep_samplers_match_jax():
    jgd, tgd = pair("linear", 50)
    t, w = td.UniformSampler(tgd).sample(16, torch.Generator().manual_seed(0),
                                        device="cpu")
    assert t.shape == (16,) and t.dtype == torch.long
    assert ((t >= 0) & (t < 50)).all() and torch.equal(w, torch.ones(16))
    ports = td.LossSecondMomentResampler(tgd, history=2)
    jaxs = jd.LossSecondMomentResampler(jgd, history=2)
    _, w = ports.sample(8, torch.Generator().manual_seed(1), device="cpu")
    _close(w, np.ones(8), dict(rtol=1e-6))
    for _ in range(2):
        for rs in (ports, jaxs):
            rs.update(np.arange(50), np.linspace(0.1, 5.0, 50))
    np.testing.assert_array_equal(ports.weights(), jaxs.weights())
    np.testing.assert_allclose(ports.weights().sum(), 1.0, rtol=1e-8)
    t, w = ports.sample(64, torch.Generator().manual_seed(2), device="cpu")
    _close(w, (1.0 / (50 * ports.weights())).astype(np.float32)[t.numpy()])
    assert ports.weights()[-1] > ports.weights()[0]


@pytest.mark.parametrize("kw", [
    {}, dict(learn_sigma=True), dict(predict_xstart=True, sigma_small=True),
    dict(use_kl=True, noise_schedule="cosine", diffusion_steps=100),
    dict(rescale_learned_sigmas=True, learn_sigma=True,
         timestep_respacing="ddim50")])
def test_create_diffusion_matches_jax(kw):
    tgd, jgd = td.create_diffusion(**kw), jd.create_diffusion(**kw)
    for attr in ("model_mean_type", "model_var_type", "loss_type"):
        assert getattr(tgd, attr).name == getattr(jgd, attr).name
    for name in TABLES:
        np.testing.assert_array_equal(getattr(tgd, name),
                                      getattr(jgd, name), err_msg=name)
