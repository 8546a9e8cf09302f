"""The port's checkpoints (`dimsum_torch/utils/ckpt.py`) against the JAX
package's (`dimsum_tpu/utils/ckpt.py`):

  * `load_torch_checkpoint` of a reference-layout `.pt` (the tiny DiM of
    `make_model_sd`, different weights under "ema" and "model"): the port's
    forward equals the JAX model's on the same file and key, within 5e-5
    (the two scans); missing, unexpected and mis-shaped keys raise in both;
    the reference's frozen buffers are skipped in both; a directory (the
    JAX package's orbax format) is refused;
  * `adapt_checkpoint` (the 256 -> 512 px warm start) against the JAX one:
    grids 16 -> 32 and 32 -> 16 and a patch-size change, every adapted
    tensor within 1e-6 of its scale, and the bicubic resize itself against
    `jax.image.resize` over several sizes;
  * `save_train_state` / `load_train_state`: the round trip is bit for
    bit, and the next step from the resumed state equals the next step
    from the saved one."""

import argparse

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax
import jax.numpy as jnp

from dimsum_tpu.models.dim import DiM as JaxDiM
from dimsum_tpu.models.dim import DiMConfig as JaxDiMConfig
from dimsum_tpu.utils import ckpt as jax_ckpt
from dimsum_torch.models.dim import DiM, DiMConfig, build_dim
from dimsum_torch.parallel import (create_optimizer, create_train_state,
                                   make_train_step)
from dimsum_torch.transport import create_transport
from dimsum_torch.utils import ckpt
from dimsum_torch.utils.convert import state_dict_from_jax_params
from tests.test_torch_convert import torch_one_thread  # noqa: F401
from tests.test_torch_transport import (JAX_PUBLISHED, TINY,
                                        tiny_state_dict)


def _template(**over):
    cfg = JaxDiMConfig(**{**TINY, **JAX_PUBLISHED, **over})
    r = cfg.img_resolution
    return JaxDiM(cfg), jax.eval_shape(
        JaxDiM(cfg).init, jax.random.PRNGKey(0), jnp.zeros((1, 4, r, r)),
        jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))["params"]


def _save(path, **entries):
    torch.save({k: ({n: torch.from_numpy(np.asarray(a)) for n, a in v.items()}
                    if isinstance(v, dict) else v)
                for k, v in entries.items()}, path)
    return str(path)


@pytest.fixture(scope="module")
def reference_file(tmp_path_factory):
    """A reference-layout .pt with distinct "ema" and "model" weights and
    the reference's extra entries (its args, a frozen wavelet buffer)."""
    ema, raw = tiny_state_dict(21), tiny_state_dict(22)
    ema["blocks.0.dwt.filters"] = np.ones((4, 1, 2, 2), np.float32)
    path = tmp_path_factory.mktemp("ckpt") / "ref.pt"
    args = argparse.Namespace(model="tiny")
    return _save(path, ema=ema, model=raw, args=args), ema, raw


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 4, 16, 16)).astype(np.float32),
            np.array([0.25, 0.75], np.float32),
            rng.integers(0, 10, 2).astype(np.int32))


@pytest.mark.parametrize("key", ["ema", "model"])
def test_load_torch_checkpoint_matches_jax(reference_file, key):
    path, ema, raw = reference_file
    jmodel, template = _template()
    params = jax_ckpt.load_torch_checkpoint(path, key=key,
                                            params_template=template)
    x, t, y = _inputs()
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, x, t, y))
    port = ckpt.load_torch_checkpoint(path, DiM(DiMConfig(**TINY)), key=key)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x), torch.from_numpy(t),
                          torch.from_numpy(y).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5, atol=5e-5)
    # the key picks the weights: EMA and raw differ
    sd = ema if key == "ema" else raw
    np.testing.assert_array_equal(port.x_embedder.proj.weight.detach(),
                                  sd["x_embedder.proj.weight"])
    other = raw if key == "ema" else ema
    assert not np.array_equal(port.pos_embed.detach().numpy(),
                              other["pos_embed"])


@pytest.mark.parametrize("fault", ["missing", "unexpected", "mis-shaped"])
def test_strict_load_raises_like_jax(tmp_path, fault):
    sd = tiny_state_dict(23)
    name = "blocks.1.spatial_mamba.mixer.in_proj.weight"
    if fault == "missing":
        del sd[name]
    elif fault == "unexpected":
        sd["blocks.1.extra.weight"] = np.zeros(3, np.float32)
    else:
        sd[name] = sd[name][:, :-1]
    path = _save(tmp_path / "bad.pt", ema=sd)
    _, template = _template()
    with pytest.raises(ValueError, match="mismatch"):
        jax_ckpt.load_torch_checkpoint(path, params_template=template)
    label = {"mis-shaped": "shape-mismatch"}.get(fault, fault)
    with pytest.raises(ValueError, match=f"{label}: \\[.*in_proj|"
                       f"{label}: \\[.*extra") as err:
        ckpt.load_torch_checkpoint(path, DiM(DiMConfig(**TINY)))
    assert "checkpoint mismatch" in str(err.value)
    # not strict: what matches loads, the rest keeps its value
    port = ckpt.load_torch_checkpoint(path, DiM(DiMConfig(**TINY)),
                                      strict=False)
    np.testing.assert_array_equal(port.pos_embed.detach(), sd["pos_embed"])


def test_orbax_directory_is_refused(tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        ckpt.load_torch_checkpoint(str(tmp_path), DiM(DiMConfig(**TINY)))


@pytest.mark.parametrize("old, new", [(8, 16), (16, 32), (32, 16), (16, 12),
                                      (7, 13)])
def test_bicubic_resize_matches_jax_image_resize(old, new):
    rng = np.random.default_rng(old * 100 + new)
    grid = rng.standard_normal((1, old * old, 6)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(grid).reshape(1, old, old, 6),
                            (1, new, new, 6), "bicubic").reshape(1, -1, 6)
    got = ckpt.resize_pos_embed(torch.from_numpy(grid), new * new)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # not PyTorch's bicubic (a = -0.75, clamped edges)
    theirs = F.interpolate(torch.from_numpy(grid).reshape(1, old, old, 6)
                           .permute(0, 3, 1, 2), size=(new, new),
                           mode="bicubic", align_corners=False)
    theirs = theirs.permute(0, 2, 3, 1).reshape(1, -1, 6)
    assert not np.allclose(theirs.numpy(), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("src, dst", [
    (dict(img_resolution=32), dict(img_resolution=64)),   # grid 16 -> 32
    (dict(img_resolution=64), dict(img_resolution=32)),   # grid 32 -> 16
    (dict(img_resolution=32), dict(img_resolution=32, patch_size=4)),
])
def test_adapt_checkpoint_matches_jax(tmp_path, src, dst):
    _, src_template = _template(**src)
    _, dst_template = _template(**dst)
    rng = np.random.default_rng(5)
    src_params = jax.tree_util.tree_map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(np.float32),
        src_template)
    want = jax_ckpt.adapt_checkpoint(src_params, dst_template)
    want_sd = state_dict_from_jax_params(want)
    src_sd = state_dict_from_jax_params(src_params)
    port_dst = DiM(DiMConfig(**{**TINY, **dst}))
    got = ckpt.adapt_checkpoint(src_sd, port_dst.state_dict())
    assert set(got) == set(want_sd)
    changed = 0
    for name, w in want_sd.items():
        assert got[name].shape == w.shape, name
        scale = max(w.abs().max().item(), 1e-30)
        assert (got[name] - w).abs().max().item() <= 1e-6 * scale, name
        changed += src_sd[name].shape != w.shape
    # pos_embed; with the patch, also the patch-embed weight and the final
    # linear's weight and bias
    assert changed == (1 if "patch_size" not in dst else 4)
    # the same through the loader, from a file
    path = _save(tmp_path / "src.pt", ema=src_sd)
    ckpt.load_torch_checkpoint(path, port_dst, adapt=True)
    torch.testing.assert_close(port_dst.pos_embed.detach(),
                               want_sd["pos_embed"], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.load_torch_checkpoint(path, DiM(DiMConfig(**{**TINY, **dst})))


def test_adapt_checkpoint_refuses_other_mismatches():
    sd = {"blocks.0.norm.weight": torch.ones(8)}
    with pytest.raises(ValueError, match="cannot adapt"):
        ckpt.adapt_checkpoint(sd, {"blocks.0.norm.weight": torch.ones(4)})


def _tiny_train_state(seed):
    model = build_dim(DiMConfig(**TINY), "cpu", seed=seed, train=True)
    opt = create_optimizer(model, lr=1e-3, weight_decay=0.1)
    state = create_train_state(model, opt)
    step = make_train_step(model, create_transport("GVP", "velocity"), opt,
                           ema_decay=0.9)
    return state, step


def _step(state, step, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 4, 16, 16, generator=g)
    y = torch.randint(0, 10, (2,), generator=g)
    return step(state, x, y, torch.Generator().manual_seed(seed))


def test_train_state_round_trip_is_exact(tmp_path):
    state, step = _tiny_train_state(0)
    for i in range(2):
        _step(state, step, i)
    path = str(tmp_path / "state.pt")
    ckpt.save_train_state(path, state)
    saved = torch.load(path, weights_only=False)
    assert set(saved) == {"model", "ema", "opt", "step", "args"}

    resumed, resumed_step = _tiny_train_state(1)
    ckpt.load_train_state(path, resumed)
    assert resumed.step == state.step == 2
    for (n, p), (_, q) in zip(state.model.named_parameters(),
                              resumed.model.named_parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(state.ema_params[n], resumed.ema_params[n]), n
        a, b = state.optimizer.state[p], resumed.optimizer.state[q]
        assert set(a) == set(b), n
        for k in a:
            assert torch.equal(a[k], b[k]), (n, k)
    # the next step is the same from either
    m1 = _step(state, step, 7)
    m2 = _step(resumed, resumed_step, 7)
    assert torch.equal(m1["loss"], m2["loss"])
    for (n, p), (_, q) in zip(state.model.named_parameters(),
                              resumed.model.named_parameters()):
        assert torch.equal(p, q), n
