"""The DiT baseline and the model factory's pair builder: the port's `DiT`
against the JAX `DiT` on the small config of tests/test_models.py:208
(latent 16, patch 2, hidden 64, depth 2, 4 heads, 10 classes), weights
from JAX's (randomized, so that no adaLN-Zero branch is silent) through
`state_dict_from_jax_params`: the forward in fp32 and bf16, CFG, the GVP
velocity loss and every gradient, the state dict back through the JAX
converter strictly and a reference-layout `.pt` loaded strictly; and the
parameter count of all 12 `DiT_models` configs against JAX's
(`jax.eval_shape`, no init; the port's on the meta device).

Tolerances: fp32 1e-4 of the output's and each gradient's scale (max
|ref|); the loss 1e-5 relative; bf16 5e-2 of the output's scale, as
tests/test_torch_dim.py's bf16 forward."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dimsum_tpu.models.dim import forward_with_cfg as jax_forward_with_cfg
from dimsum_tpu.models.dit import DiT as JaxDiT
from dimsum_tpu.models.dit import DiT_models as JaxDiT_models
from dimsum_tpu.models.dit import DiTConfig as JaxDiTConfig
from dimsum_tpu.transport import create_transport as jax_transport
from dimsum_tpu.utils.ckpt import convert_torch_state_dict
from dimsum_torch.models.dim import forward_with_cfg
from dimsum_torch.models.dit import DiT, DiT_models, DiTConfig
from dimsum_torch.utils.convert import state_dict_from_jax_params
from tests.test_torch_convert import (randomize,  # noqa: F401
                                      torch_one_thread)
from tests.test_torch_train import (_assert_scaled, _grads_by_name,
                                    _patch_jax_sample, fixed_transport)

DIT_SMALL = dict(img_resolution=16, patch_size=2, hidden_size=64, depth=2,
                 num_heads=4, num_classes=10)
FP32_TOL, BF16_TOL = 1e-4, 5e-2


def jax_port_pair(jmodel, port, seed=0, img=16):
    """(randomized JAX params of `jmodel` (shapes from `jax.eval_shape`,
    no compiled init), `port` with the same weights loaded strictly)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(seed),
                            jnp.zeros((2, 4, img, img)), jnp.zeros((2,)),
                            jnp.zeros((2,), jnp.int32))
    params = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), seed)
    port.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return params, port


def model_inputs(seed, n=2, img=16, classes=10):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4, img, img)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, n).astype(np.float32)
    y = rng.integers(0, classes, n).astype(np.int32)
    return x, t, y


def forward_and_cfg(jmodel, params, port, seed=1, img=16, tol=FP32_TOL):
    """The forward and the CFG forward of both packages on the same numpy
    inputs, each within `tol` of the JAX output's scale."""
    x, t, y = model_inputs(seed, img=img)
    xc, tc = np.concatenate([x, x]), np.concatenate([t, t])
    yc = np.concatenate([y, np.full(2, 10, np.int32)])

    def both(p, x, t, y, xc, tc, yc):
        return (jmodel.apply(p, x, t, y),
                jax_forward_with_cfg(jmodel.apply, p, xc, tc, yc,
                                     cfg_scale=1.4))

    want, want_cfg = jax.jit(both)(params, x, t, y, xc, tc, yc)
    with torch.no_grad():
        got = port.eval()(*map(torch.from_numpy, (x, t)),
                          torch.from_numpy(y).long())
        got_cfg = forward_with_cfg(port, *map(torch.from_numpy, (xc, tc)),
                                   torch.from_numpy(yc).long(),
                                   cfg_scale=1.4)
    assert got.dtype == torch.float32
    _assert_scaled(got.numpy(), want, tol, "forward")
    _assert_scaled(got_cfg.numpy(), want_cfg, tol, "cfg")
    return got


def loss_and_grads(jmodel, params, port, seed=2, img=16, drop_ids=None):
    """The GVP velocity loss of both packages with the same (t, x0) draws
    and label-drop ids, then every gradient: the loss 1e-5 relative, each
    gradient 1e-4 of its largest value.  Returns the port's gradients."""
    drop_ids = np.array([0, 1, 0], np.int32) if drop_ids is None \
        else drop_ids
    rng = np.random.default_rng(seed)
    x1, x0 = (rng.standard_normal((3, 4, img, img)).astype(np.float32)
              for _ in range(2))
    t = rng.uniform(0.05, 0.95, 3).astype(np.float32)
    y = rng.integers(0, 10, 3).astype(np.int32)

    def loss_fn(p):
        def model_fn(xt, t_, **kw):
            return jmodel.apply(p, xt, t_, train=True,
                                rngs={"drop_path": jax.random.PRNGKey(9),
                                      "label_dropout":
                                          jax.random.PRNGKey(9)}, **kw)
        terms = jax_transport("GVP", "velocity").training_losses(
            model_fn, jax.random.PRNGKey(0), x1,
            {"y": y, "force_drop_ids": drop_ids})
        return terms["loss"].mean()

    with pytest.MonkeyPatch.context() as mp:
        _patch_jax_sample(mp, t, x0)
        want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tr = fixed_transport(t, x0, force_drop_ids=drop_ids)
    port.train()
    loss = tr.training_losses(
        lambda xt, t_, **kw: port(xt, t_, train=True, **kw),
        torch.from_numpy(x1), None,
        {"y": torch.from_numpy(y).long()})["loss"].mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = state_dict_from_jax_params(want_grads)
    got = _grads_by_name(port)
    assert set(got) == set(want)
    for name, g in got.items():
        _assert_scaled(g.numpy(), want[name].numpy(), FP32_TOL, name)
    return got


@pytest.fixture(scope="module")
def dit_pair():
    jmodel = JaxDiT(JaxDiTConfig(**DIT_SMALL))
    params, port = jax_port_pair(jmodel, DiT(DiTConfig(**DIT_SMALL)))
    return jmodel, params, port


def test_dit_forward_and_cfg_match_jax(dit_pair):
    jmodel, params, port = dit_pair
    got = forward_and_cfg(jmodel, params, port)
    assert got.shape == (2, 4, 16, 16)


def test_dit_bf16_forward_tracks_jax(dit_pair):
    _, params, _ = dit_pair
    jmodel = JaxDiT(JaxDiTConfig(**DIT_SMALL, dtype=jnp.bfloat16))
    port = DiT(DiTConfig(**DIT_SMALL, dtype=torch.bfloat16))
    port.load_state_dict(state_dict_from_jax_params(params), strict=True)
    forward_and_cfg(jmodel, params, port, tol=BF16_TOL)


def test_dit_loss_and_grads_match_jax(dit_pair):
    jmodel, params, _ = dit_pair
    port = DiT(DiTConfig(**DIT_SMALL))
    port.load_state_dict(state_dict_from_jax_params(params), strict=True)
    got = loss_and_grads(jmodel, params, port)
    # the fixed APE takes no gradient in either package
    assert not got["pos_embed"].any()


def test_dit_grad_checkpoint_equals_plain(dit_pair):
    """Full remat of each block gives the gradients of the run without."""
    _, params, _ = dit_pair
    sd = state_dict_from_jax_params(params)
    x, t, y = model_inputs(4)
    w = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 4, 16, 16)).astype(np.float32))
    grads = []
    for remat in (False, True):
        m = DiT(DiTConfig(**DIT_SMALL, grad_checkpoint=remat))
        m.load_state_dict(sd, strict=True)
        out = m(*map(torch.from_numpy, (x, t)), torch.from_numpy(y).long())
        (out * w).sum().backward()
        grads.append(_grads_by_name(m))
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name],
                                   rtol=0, atol=0)


def test_dit_state_dict_is_the_reference_layout(dit_pair, tmp_path):
    """The port's state dict carries the reference's timm names: back
    through the JAX converter strictly to the same tree, and as a `.pt`
    loaded strictly into a fresh DiT."""
    from dimsum_torch.utils.ckpt import load_torch_checkpoint

    _, params, port = dit_pair
    sd = port.state_dict()
    for key in ("blocks.0.attn.qkv.weight", "blocks.0.attn.proj.bias",
                "blocks.1.mlp.fc1.weight", "blocks.1.mlp.fc2.bias",
                "blocks.1.adaLN_modulation.1.weight",
                "final_layer.adaLN_modulation.1.weight", "pos_embed"):
        assert key in sd, key
    back = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()},
                                    params["params"], strict=True)
    flat = jax.tree_util.tree_leaves_with_path
    got = {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat(back)}
    want = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in flat(params["params"])}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    torch.save({"ema": sd}, tmp_path / "dit.pt")
    dst = load_torch_checkpoint(str(tmp_path / "dit.pt"),
                                DiT(DiTConfig(**DIT_SMALL)))
    for k, v in sd.items():
        torch.testing.assert_close(dst.state_dict()[k], v, rtol=0, atol=0)
    del sd["blocks.1.mlp.fc2.weight"]
    torch.save({"ema": sd}, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="missing"):
        load_torch_checkpoint(str(tmp_path / "bad.pt"),
                              DiT(DiTConfig(**DIT_SMALL)))


@pytest.mark.parametrize("name", sorted(JaxDiT_models))
def test_dit_zoo_parameter_counts_match_jax(name):
    jcfg = JaxDiT_models[name](img_resolution=32)
    shapes = jax.eval_shape(JaxDiT(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4, 32, 32)), jnp.zeros((1,)),
                            jnp.zeros((1,), jnp.int32))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes))
    cfg = DiT_models[name](img_resolution=32)
    assert (cfg.depth, cfg.hidden_size, cfg.patch_size, cfg.num_heads) == (
        jcfg.depth, jcfg.hidden_size, jcfg.patch_size, jcfg.num_heads)
    with torch.device("meta"):
        port = DiT(cfg)
    assert sum(p.numel() for p in port.parameters()) == want
