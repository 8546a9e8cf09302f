"""The port's 512-px slice against the JAX package on a narrow DiM at
`img_resolution=64` (latent 64, patch 2: a 32 x 32 grid, L = 1024 tokens;
hidden 128, depth 4, a shared DiT block after the 4th block, the shape of
tests/test_512res.py): the frequency half takes the dwt_tokens +
local_scan route (side 32, window 8), and pos_embed is (1, 1024, D).

  * the weights carry across both ways, pos_embed included;
  * one forward, the CFG forward and a 4-point Euler sample (GVP velocity,
    CFG 1.4) from the same numpy noise;
  * the flow-matching loss and every parameter's gradient of one training
    step against `jax.value_and_grad`, with the draws injected (fixed t,
    x0 and label-drop ids);
  * the sampling and training benchmarks' entry points at 512 px on the
    CPU, with a narrower zoo model.

At this width the heads are narrow (Dh 8), so the attention takes SDPA in
the port and XLA's attention in the JAX package; the full-block route at
L = 1024 is held to the JAX package in tests/test_torch_attention.py.

Tolerances, fp32, as tests/test_torch_dim.py and tests/test_torch_train.py
(the JAX CPU route scans with an associative scan, the port sequentially,
~1e-6 relative per mixer): forward and CFG 5e-5, the 4-step sample 1e-4,
the loss 1e-5 relative, each gradient 1e-3 of its tensor's largest value."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dimsum_tpu.models.dim import DiM as JaxDiM
from dimsum_tpu.models.dim import DiMConfig as JaxDiMConfig
from dimsum_tpu.models.dim import forward_with_cfg as jax_forward_with_cfg
from dimsum_tpu.transport import Sampler as JaxSampler
from dimsum_tpu.transport import create_transport as jax_create_transport
from dimsum_tpu.utils.ckpt import convert_torch_state_dict
from dimsum_torch.models.dim import DiM, DiMConfig, forward_with_cfg
from dimsum_torch.transport import Sampler, create_transport
from dimsum_torch.utils.convert import state_dict_from_jax_params
from tests.test_torch_convert import (PUBLISHED, _flat,  # noqa: F401
                                      randomize, torch_one_thread)
from tests.test_torch_train import (_assert_scaled, _grads_by_name,
                                    _patch_jax_sample, fixed_transport)

NARROW512 = dict(img_resolution=64, hidden_size=128, depth=4,
                 use_attn_every_k_layers=4, num_classes=10,
                 label_dropout=0.1)
LATENT = 64


def _inputs(seed, n=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4, LATENT, LATENT)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, n).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, t, y


@pytest.fixture(scope="module")
def models():
    """(jax model, randomized jax params, port model with those weights)."""
    jmodel = JaxDiM(JaxDiMConfig(**NARROW512, **PUBLISHED))
    z = jnp.zeros((2, 4, LATENT, LATENT))
    params = randomize(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), z, jnp.zeros((2,)),
        jnp.zeros((2,), jnp.int32)), 0)
    port = DiM(DiMConfig(**NARROW512))
    port.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jmodel, params, port.eval()


def test_dim512_weights_round_trip_exact(models):
    _, params, port = models
    assert params["params"]["pos_embed"].shape == (1, 1024, 128)
    sd = state_dict_from_jax_params(params)
    assert sd["pos_embed"].shape == port.pos_embed.shape == (1, 1024, 128)
    back = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()},
                                    params["params"], strict=True)
    want, got = _flat(params["params"]), _flat(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_dim512_forward_matches_jax(models):
    jmodel, params, port = models
    x, t, y = _inputs(0)
    want = jax.jit(jmodel.apply)(params, x, t, y)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t),
                   torch.from_numpy(y).long())
    assert got.shape == (2, 4, LATENT, LATENT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)


def test_dim512_cfg_forward_matches_jax(models):
    jmodel, params, port = models
    x, t, y = _inputs(1)
    x, t = np.concatenate([x, x]), np.concatenate([t, t])
    y = np.concatenate([y, np.full(2, 10, np.int32)])
    want = jax.jit(lambda p, x, t, y: jax_forward_with_cfg(
        jmodel.apply, p, x, t, y, cfg_scale=1.4))(params, x, t, y)
    with torch.no_grad():
        got = forward_with_cfg(port, torch.from_numpy(x), torch.from_numpy(t),
                               torch.from_numpy(y).long(), cfg_scale=1.4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)


def test_dim512_euler_sample_matches_jax(models):
    """4-point Euler grid on GVP velocity with CFG 1.4, as the bench runs
    it at 512 px."""
    jmodel, params, port = models
    x, _, y = _inputs(2, n=1)
    z = np.concatenate([x, x])
    y = np.concatenate([y, np.full(1, 10, np.int32)])
    jsample = JaxSampler(jax_create_transport("GVP", "velocity")).sample_ode(
        sampling_method="euler", num_steps=4)
    want = jax.jit(lambda p, z, y: jsample(
        z, lambda x_, t_, y=None: jax_forward_with_cfg(
            jmodel.apply, p, x_, t_, y, cfg_scale=1.4), y=y))(params, z, y)
    sample = Sampler(create_transport("GVP", "velocity")).sample_ode(
        sampling_method="euler", num_steps=4)
    with torch.no_grad():
        got = sample(torch.from_numpy(z),
                     lambda x_, t_, y=None: forward_with_cfg(
                         port, x_, t_, y, cfg_scale=1.4),
                     y=torch.from_numpy(y).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_dim512_loss_and_grads_match_jax(monkeypatch, models):
    """One training loss at 512 px (label dropout with fixed drop ids, no
    stochastic depth) and every parameter's gradient."""
    jmodel, params, _ = models
    x1, t, _ = _inputs(3)
    x0 = np.random.default_rng(4).standard_normal(x1.shape).astype(
        np.float32)
    y = np.array([3, 7], np.int32)
    drop_ids = np.array([0, 1], np.int32)

    def loss_fn(p):
        def model_fn(xt, t_, **kw):
            return jmodel.apply(p, xt, t_, train=True,
                                rngs={"label_dropout":
                                      jax.random.PRNGKey(9)}, **kw)
        terms = jax_create_transport("GVP", "velocity").training_losses(
            model_fn, jax.random.PRNGKey(0), x1,
            {"y": y, "force_drop_ids": drop_ids})
        return terms["loss"].mean()

    _patch_jax_sample(monkeypatch, t, x0)
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)

    port = DiM(DiMConfig(**NARROW512))
    port.load_state_dict(state_dict_from_jax_params(params), strict=True)
    port.train()
    tr = fixed_transport(t, x0, force_drop_ids=drop_ids)
    loss = tr.training_losses(
        lambda xt, t_, **kw: port(xt, t_, train=True, **kw),
        torch.from_numpy(x1), None,
        {"y": torch.from_numpy(y).long()})["loss"].mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = state_dict_from_jax_params(jgrads)
    got = _grads_by_name(port)
    assert set(got) == set(want)
    for name in sorted(want):
        _assert_scaled(got[name].numpy(), want[name].numpy(), 1e-3, name)


def test_bench_entry_point_runs_at_512_on_cpu():
    """`bench.run` at 512 px end to end, on the CPU only because the caller
    asks for it, with a narrow model and 3 grid points."""
    from dimsum_torch.bench import run

    record, samples = run(batch=1, steps=3, dtype="fp32", device="cpu",
                          model="DiM-S/2", image_size=512)
    assert samples.shape == (1, 4, LATENT, LATENT)
    assert torch.isfinite(samples).all()
    assert record["metric"] == "imagenet512_sampling_throughput_3step_cfg"
    with pytest.raises(ValueError, match="image_size"):
        run(batch=1, steps=2, device="cpu", model="DiM-S/2", image_size=384)


def test_train_bench_entry_point_runs_at_512_on_cpu():
    """`train_bench.run` at 512 px on the CPU with a narrow model: the
    attention's Function and the scan give gradients, and the step moves
    the parameters."""
    from dimsum_torch.train_bench import run

    record, state = run(model="DiM-S/2", batch=1, steps=1, warmup=0,
                        device="cpu", image_size=512)
    assert record["metric"] == "imagenet512_train_throughput"
    assert np.isfinite(record["loss"]).all()
    assert np.isfinite(record["grad_norm"]).all()
    assert state.model.pos_embed.shape == (1, 1024, 256)
