"""The DiM zoo's other configurations in the port against the JAX package,
on a small DiM (latent 16: grid 8, L 64; hidden 64; depth 4, so that the
i % 4 transposes run; 10 classes): block types linear, raw, wave, window,
combined_fourier (the DCT half, jpeg_2 mixers) and combined_einfft; scan
types none, v2 and zigma_8; the published configuration against JAX's
with the reverse inside its mixers (DIMSUM_NATIVE_REVERSE: the port's
reversed blocks do that in every case here, under no_grad); and
one configuration with LayerNorm, plain Mamba, learn_sigma, a final norm,
independent DiT blocks, the plain MLP, serpentine continuity and the
auxiliary fourier blocks.

Each configuration's JAX weights (JAX `init`, randomized) go to the port
through `state_dict_from_jax_params` and load strictly; the port's state
dict goes back through `convert_torch_state_dict(strict=True)` to the
same tree.  Then the forward and the CFG forward against JAX's, and for
linear + v2 (which trains through flips around the scan) the loss and
every gradient against `jax.value_and_grad`.  Also: `cli.model_config`
builds each variant from the JAX flags.

Tolerances (fp32): the forwards 5e-5, as tests/test_torch_dim.py (the JAX
CPU scan is associative, the port's sequential: ~1e-6 a mixer); the loss
and gradients as tests/test_torch_train.py (loss 1e-5 relative, each
gradient 1e-3 of its largest value)."""

import argparse

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import dimsum_tpu.models.blocks as jax_blocks
import dimsum_torch.models.blocks as port_blocks
from dimsum_tpu.models.dim import DiM as JaxDiM
from dimsum_tpu.models.dim import DiMConfig as JaxDiMConfig
from dimsum_tpu.models.dim import forward_with_cfg as jax_forward_with_cfg
from dimsum_tpu.models.embedders import get_2d_sincos_pos_embed
from dimsum_tpu.transport import create_transport as jax_transport
from dimsum_tpu.utils.ckpt import convert_torch_state_dict
from dimsum_torch import cli
from dimsum_torch.models.dim import DiM, DiMConfig, forward_with_cfg
from dimsum_torch.utils.convert import state_dict_from_jax_params
from tests.test_torch_convert import (randomize,  # noqa: F401
                                      torch_one_thread)
from tests.test_torch_train import (_assert_scaled, _grads_by_name,
                                    _patch_drop_path, _patch_jax_sample,
                                    fixed_transport)

SMALL = dict(img_resolution=16, hidden_size=64, depth=4, num_classes=10)
# the JAX CLI's defaults (LayerNorm, plain Mamba, a fixed APE, no DiT
# block) and the published flags
CLI_DEFAULTS = dict(rms_norm=False, cond_mamba=False, learnable_pe=False,
                    use_attn_every_k_layers=-1)
PUBLISHED = dict(rms_norm=True, cond_mamba=True, learnable_pe=True,
                 use_attn_every_k_layers=4)
CASES = {
    "linear-v2": dict(block_type="linear", scan_type="v2", **CLI_DEFAULTS),
    "linear-none": dict(block_type="linear", scan_type="none", **PUBLISHED),
    "raw-v2": dict(block_type="raw", scan_type="v2", **PUBLISHED),
    "raw-none": dict(block_type="raw", scan_type="none", **CLI_DEFAULTS),
    "linear-zigma_8": dict(block_type="linear", scan_type="zigma_8",
                           **PUBLISHED),
    "wave": dict(block_type="wave", scan_type="none", **PUBLISHED),
    "window": dict(block_type="window", scan_type="none", **CLI_DEFAULTS),
    "combined_fourier": dict(block_type="combined_fourier",
                             scan_type="none", **PUBLISHED),
    "combined_einfft": dict(block_type="combined_einfft", scan_type="none",
                            **PUBLISHED),
    "published-native-reverse": dict(block_type="combined",
                                     scan_type="none", native_reverse=True,
                                     **PUBLISHED),
    "options": dict(block_type="linear", scan_type="none", rms_norm=False,
                    cond_mamba=False, learnable_pe=True, learn_sigma=True,
                    use_final_norm=True, use_independent_attn=True,
                    use_attn_every_k_layers=2, use_gated_mlp=False,
                    scanning_continuity=True, enable_fourier_layers=True),
}
TOL = dict(rtol=5e-5, atol=5e-5)


def _models(case, seed=0, monkeypatch=None, **extra):
    """(jax model, randomized jax params, port model with them)."""
    kw = dict(CASES[case], **extra)
    if kw.pop("native_reverse", False):  # JAX's switch; the port has none
        monkeypatch.setenv("DIMSUM_NATIVE_REVERSE", "1")
    jmodel = JaxDiM(JaxDiMConfig(**SMALL, **kw))
    # the params' shapes without compiling `init` (the longest compile of
    # a case); randomize refills every leaf, the APE from its table
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(seed),
                            jnp.zeros((2, 4, 16, 16)), jnp.zeros((2,)),
                            jnp.zeros((2,), jnp.int32))
    ape = get_2d_sincos_pos_embed(SMALL["hidden_size"], 8)[None]
    params = randomize(jax.tree_util.tree_map_with_path(
        lambda path, s: (ape if str(getattr(path[-1], "key", "")) ==
                         "pos_embed" else np.zeros(s.shape, s.dtype)),
        shapes), seed)
    port = DiM(DiMConfig(**SMALL, **kw))
    port.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jmodel, params, port


def _flat(tree):
    return {tuple(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("case", list(CASES))
def test_variant_forward_and_cfg_match_jax(case, monkeypatch):
    jmodel, params, port = _models(case, monkeypatch=monkeypatch)
    # the weights back to the JAX tree, strictly, bit for bit
    back = convert_torch_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()},
        params["params"], strict=True)
    want_tree, got_tree = _flat(params["params"]), _flat(back)
    assert set(got_tree) == set(want_tree)
    for k in want_tree:
        np.testing.assert_array_equal(got_tree[k], want_tree[k],
                                      err_msg=str(k))

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, 2).astype(np.float32)
    y = rng.integers(0, 10, 2).astype(np.int32)
    xc, tc = np.concatenate([x, x]), np.concatenate([t, t])
    yc = np.concatenate([y, np.full(2, 10, np.int32)])

    def both(p, x, t, y, xc, tc, yc):
        return (jmodel.apply(p, x, t, y),
                jax_forward_with_cfg(jmodel.apply, p, xc, tc, yc,
                                     cfg_scale=1.4))

    want, want_cfg = jax.jit(both)(params, x, t, y, xc, tc, yc)
    out_ch = 8 if CASES[case].get("learn_sigma") else 4
    with torch.no_grad():
        got = port.eval()(*map(torch.from_numpy, (x, t)),
                          torch.from_numpy(y).long())
        got_cfg = forward_with_cfg(port, *map(torch.from_numpy, (xc, tc)),
                                   torch.from_numpy(yc).long(),
                                   cfg_scale=1.4)
    assert got.shape == (2, out_ch, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_cfg.numpy(), np.asarray(want_cfg), **TOL)


def test_linear_v2_loss_and_grads_match_jax(monkeypatch):
    """linear + v2 with stochastic depth 0.2 (blocks 2 and 3 drop, with
    fixed masks in both packages), label dropout with fixed ids, the GVP
    velocity loss: the `_b` branch trains through flips around the
    autograd Function in the port, through `_dtlow_fwd`/`_dtlow_bwd`'s
    flips in JAX."""
    masks = np.array([[1, 0, 1], [0, 1, 1]], np.float32)
    drop_ids = np.array([0, 1, 0], np.int32)
    jmodel, params, port = _models("linear-v2", drop_path=0.2,
                                   label_dropout=0.1)
    rng = np.random.default_rng(2)
    x1, x0 = (rng.standard_normal((3, 4, 16, 16)).astype(np.float32)
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

    with monkeypatch.context() as mp:
        _patch_jax_sample(mp, t, x0)
        jcalls = _patch_drop_path(mp, jax_blocks, masks, jnp.asarray)
        want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)

    calls = _patch_drop_path(monkeypatch, port_blocks, masks,
                             torch.from_numpy)
    tr = fixed_transport(t, x0, force_drop_ids=drop_ids)
    port.train()
    loss = tr.training_losses(
        lambda xt, t_, **kw: port(xt, t_, train=True, **kw),
        torch.from_numpy(x1), None,
        {"y": torch.from_numpy(y).long()})["loss"].mean()
    loss.backward()
    assert len(calls) == len(jcalls) == 2
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = state_dict_from_jax_params(want_grads)
    got = _grads_by_name(port)
    assert set(got) == set(want)
    for name, g in got.items():
        _assert_scaled(g.numpy(), want[name].numpy(), 1e-3, name)
    # the fixed APE takes no gradient
    assert port.pos_embed.grad is None
    assert not np.asarray(want_grads["params"]["pos_embed"]).any()


def _namespace(argv):
    p = argparse.ArgumentParser()
    cli.add_model_args(p)
    cli.add_moe_args(p)
    return p.parse_args(argv)


@pytest.mark.parametrize("argv, want", [
    ([], dict(block_type="linear", scan_type="v2", rms_norm=False,
              cond_mamba=False, learnable_pe=False)),
    (["--block-type", "raw", "--bimamba-type", "none", "--rms-norm"],
     dict(block_type="raw", scan_type="none", rms_norm=True)),
    (["--block-type", "window", "--bimamba-type", "zigma_8"],
     dict(block_type="window", scan_type="zigma_8")),
    (["--block-type", "wave", "--not-use-gated-mlp", "--learn-sigma",
      "--use-final-norm", "--scanning-continuity",
      "--enable-fourier-layers"],
     dict(block_type="wave", use_gated_mlp=False, learn_sigma=True,
          use_final_norm=True, scanning_continuity=True,
          enable_fourier_layers=True)),
    (["--block-type", "combined_fourier", "--cond-mamba", "--learnable-pe"],
     dict(block_type="combined_fourier", cond_mamba=True,
          learnable_pe=True)),
    (["--block-type", "combined_einfft", "--bimamba-type", "jpeg_8"],
     dict(block_type="combined_einfft", scan_type="jpeg_8")),
])
def test_model_config_builds_the_variants(argv, want):
    cfg = cli.model_config(_namespace(
        ["--model", "DiM-S/2", "--image-size", "64", "--num-classes", "10",
         *argv]))
    for k, v in want.items():
        assert getattr(cfg, k) == v, k
    with torch.no_grad():
        out = DiM(cfg)(torch.zeros(1, 4, 8, 8), torch.zeros(1),
                       torch.zeros(1, dtype=torch.long))
    assert out.shape == (1, cfg.out_channels, 8, 8)


@pytest.mark.parametrize("case", ["linear-zigma_8", "combined_fourier",
                                  "options"])
def test_reference_checkpoint_of_a_variant_loads_strictly(case, tmp_path):
    """A reference-layout `.pt` ("ema" under the reference's key names,
    with its frozen zigzag-path buffers, which the port regenerates and
    skips as the JAX converter does) loads strictly into a fresh model."""
    from dimsum_torch.models.dim import random_init_
    from dimsum_torch.utils.ckpt import load_torch_checkpoint

    kw = dict(CASES[case])
    src = random_init_(DiM(DiMConfig(**SMALL, **kw)), seed=4)
    sd = dict(src.state_dict())
    L = (SMALL["img_resolution"] // 2) ** 2
    sd["zigzag_paths"] = torch.zeros(8, L, dtype=torch.long)
    sd["blocks.0.mixer.zigzag_paths_reverse"] = torch.zeros(
        8, L, dtype=torch.long)
    torch.save({"ema": sd}, tmp_path / "ckpt.pt")
    dst = load_torch_checkpoint(str(tmp_path / "ckpt.pt"),
                                DiM(DiMConfig(**SMALL, **kw)))
    for k, v in src.state_dict().items():
        torch.testing.assert_close(dst.state_dict()[k], v, rtol=0, atol=0)
    del sd["blocks.0.norm_2.weight" if case != "combined_fourier"
           else "blocks.0.freq_mamba.mixer.A_log"]
    torch.save({"ema": sd}, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="missing"):
        load_torch_checkpoint(str(tmp_path / "bad.pt"),
                              DiM(DiMConfig(**SMALL, **kw)))
