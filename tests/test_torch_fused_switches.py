"""The JAX package's fused-kernel switches through the port's CLIs.  The
factory (`dimsum_torch/models/factory.py::fused_switches`, which `sample`,
`sample_ddp`, `train` and `profile_forward` build by) reads
DIMSUM_PALLAS_NORM, DIMSUM_FUSED_NORM, DIMSUM_CONV_XPROJ and
DIMSUM_PENDING_TAIL as the JAX package reads them at call time, and the
bench CLIs' flags set the same fields:

  * each switch sets its config field; DIMSUM_PENDING_TAIL is read by the
    JAX `pending_tail_mode` (not an integer: 0), above 0 it defers the
    tail, at 2 through the kernel; a DiT takes DIMSUM_FUSED_NORM and
    ignores the three that the JAX DiT never reads;
  * a tiny fp32 DiM built through the CLI's `model_config` with every
    switch set matches the JAX model that the JAX `create_model` builds
    from the same argv under the same environment (its Pallas kernels in
    interpret mode, as tests/test_torch_fused_model.py runs them), at that
    file's 5e-5, and every mixer went through the port's conv + x_proj
    entry (its plain version on the CPU, counted);
  * `bench.fused_settings` takes a flag or its variable."""

import argparse
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import dimsum_tpu.models.blocks as jax_blocks
import dimsum_tpu.models.dim as jax_dim
from dimsum_tpu import cli as jax_cli
from dimsum_tpu.models.factory import create_model as jax_create_model
from dimsum_tpu.ops.conv_xproj import \
    conv_xproj_supported as jax_conv_xproj_supported
from dimsum_torch import bench, cli
from dimsum_torch.models import dim as port_dim
from dimsum_torch.models.dim import DiM
from dimsum_torch.models.dit import DiTConfig
from dimsum_torch.models.factory import FUSED_SWITCHES
from dimsum_torch.models.mamba import Mamba
from dimsum_torch.ops import conv_xproj as port_cx
from dimsum_torch.utils.convert import state_dict_from_jax_params
from tests.test_torch_convert import randomize, torch_one_thread  # noqa: F401

# hidden 128, depth 4, a shared DiT block after the 4th, latent 32 (the
# small DiM of tests/test_torch_fused_model.py), the published block
ARGV = ["--model", "DiM-T/2", "--image-size", "256", "--num-classes", "10",
        "--label-dropout", "0.1", "--block-type", "combined",
        "--bimamba-type", "none", "--rms-norm", "--cond-mamba",
        "--learnable-pe", "--use-attn-every-k-layers", "4"]
ALL_SET = {"DIMSUM_PALLAS_NORM": "1", "DIMSUM_FUSED_NORM": "1",
           "DIMSUM_CONV_XPROJ": "1", "DIMSUM_PENDING_TAIL": "2"}


def _parse(module, argv):
    p = argparse.ArgumentParser()
    module.add_model_args(p)
    module.add_moe_args(p)
    return p.parse_args(argv)


@pytest.fixture
def tiny_zoo(monkeypatch):
    """DiM-T/2 in both packages' zoos."""
    monkeypatch.setitem(jax_dim.DiM_models, "DiM-T/2",
                        lambda **kw: jax_dim._zoo_cfg(4, 128, 2, **kw))
    monkeypatch.setitem(port_dim.DiM_models, "DiM-T/2",
                        lambda **kw: port_dim._zoo_cfg(4, 128, 2, **kw))


@pytest.fixture
def clean_env(monkeypatch):
    for name in FUSED_SWITCHES:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_without_the_switches_every_field_is_off(clean_env):
    cfg = cli.model_config(_parse(cli, ["--model", "DiM-S/2"]))
    assert (cfg.pallas_norm, cfg.fused_norm, cfg.conv_xproj,
            cfg.pending_tail) == (False, False, False, 0)


@pytest.mark.parametrize("name, field", [
    ("DIMSUM_PALLAS_NORM", "pallas_norm"), ("DIMSUM_FUSED_NORM", "fused_norm"),
    ("DIMSUM_CONV_XPROJ", "conv_xproj")])
@pytest.mark.parametrize("value", ["1", "0", "true", " 1"])
def test_each_switch_sets_its_field(name, field, value, clean_env):
    """On exactly at "1", as the JAX gates compare (for DIMSUM_CONV_XPROJ
    the JAX gate itself decides, on a shape it takes)."""
    clean_env.setenv(name, value)
    cfg = cli.model_config(_parse(cli, ["--model", "DiM-S/2"]))
    assert getattr(cfg, field) is (value == "1")
    others = {f for f in ("pallas_norm", "fused_norm", "conv_xproj")
              if f != field}
    assert not any(getattr(cfg, f) for f in others) and cfg.pending_tail == 0
    if name == "DIMSUM_CONV_XPROJ":
        assert cfg.conv_xproj is jax_conv_xproj_supported(
            jnp.zeros((1, 16, 256)), jnp.zeros((256, 48)))


@pytest.mark.parametrize("value", ["0", "1", "2", "3", "-1", "x", "", "2.0"])
def test_pending_tail_reads_as_jax_reads_it(value, clean_env):
    clean_env.setenv("DIMSUM_PENDING_TAIL", value)
    mode = jax_blocks.pending_tail_mode()
    cfg = cli.model_config(_parse(cli, ["--model", "DiM-S/2"]))
    # JAX defers the tail where the mode is above 0 and takes the kernel
    # for it at 2 (dim.py:344-355, blocks.py:805)
    assert cfg.pending_tail == (2 if mode == 2 else int(mode > 0))
    assert {"1": 1, "2": 2, "3": 1}.get(value, 0) == cfg.pending_tail


def test_a_dit_takes_only_the_fused_norm_switch(clean_env):
    for name, value in ALL_SET.items():
        clean_env.setenv(name, value)
    cfg = cli.model_config(_parse(cli, ["--model", "DiT-S/8"]))
    assert isinstance(cfg, DiTConfig) and cfg.fused_norm
    clean_env.setenv("DIMSUM_FUSED_NORM", "0")
    assert not cli.model_config(_parse(cli, ["--model", "DiT-S/8"])).fused_norm


def test_bench_flags_and_switches_set_the_same_fields(clean_env):
    ap = argparse.ArgumentParser()
    bench.add_fused_flags(ap)
    assert bench.fused_settings(ap.parse_args([])) == bench.FUSED_DEFAULTS
    for name, value in ALL_SET.items():
        clean_env.setenv(name, value)
    want = dict(pallas_norm=True, fused_norm=True, conv_xproj=True,
                pending_tail=2)
    assert bench.fused_settings(ap.parse_args([])) == want
    assert bench.fused_settings(ap.parse_args(["--pending-tail", "1"])) == \
        dict(want, pending_tail=1)
    assert bench.fused_settings(ap.parse_args([]), dit=True) == \
        dict(bench.FUSED_DEFAULTS, fused_norm=True)
    for name in ALL_SET:
        clean_env.delenv(name)
    flags = ["--pallas-norm", "--fused-norm", "--conv-xproj",
             "--pending-tail", "2"]
    assert bench.fused_settings(ap.parse_args(flags)) == want


def test_cli_built_dim_under_the_switches_matches_jax(tiny_zoo, clean_env):
    """Every switch set, as a user sets them for the JAX sample.py."""
    for name, value in ALL_SET.items():
        clean_env.setenv(name, value)
    clean_env.setenv("DIMSUM_NORM_INTERPRET", "1")  # the JAX norm kernels
    jmodel, jcfg = jax_create_model(_parse(jax_cli, ARGV))
    cfg = cli.model_config(_parse(cli, ARGV))
    assert (cfg.pallas_norm, cfg.fused_norm, cfg.conv_xproj,
            cfg.pending_tail) == (True, True, True, 2)
    assert cfg.hidden_size == jcfg.hidden_size == 128
    assert {f.name for f in dataclasses.fields(cfg)} >= set(
        FUSED_SWITCHES.values())

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 32, 32)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, 2).astype(np.float32)
    y = rng.integers(0, 10, 2).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        params = randomize(jax.jit(jmodel.init)(
            jax.random.PRNGKey(1), jnp.zeros((2, 4, 32, 32)),
            jnp.zeros((2,)), jnp.zeros((2,), jnp.int32)), 1)
        want = np.asarray(jax.jit(jmodel.apply)(params, x, t, y))

    port = DiM(cfg)
    port.load_state_dict(state_dict_from_jax_params(params), strict=True)
    calls = []
    ref = port_cx.conv_xproj_ref
    clean_env.setattr(port_cx, "conv_xproj_ref",
                      lambda *a, **k: calls.append(1) or ref(*a, **k))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x), torch.from_numpy(t),
                          torch.from_numpy(y).long()).numpy()
    mixers = sum(isinstance(m, Mamba) for m in port.modules())
    assert mixers == 8 and len(calls) == mixers
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)
