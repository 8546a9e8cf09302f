"""The port's model factory (`dimsum_torch/models/factory.py`, which the
CLIs use) against the JAX `create_model` on the same argv: for each model
flag of the JAX CLIs (DiT, MoE with its group, `--pe-type`, `--cond-init`,
`--mamba-moe-layers`, `--bf16`), every config field the two packages
share is equal, and the port's module has the JAX module's parameters:
the JAX tree's shapes (`jax.eval_shape`, no init) converted by
`state_dict_from_jax_params` give the port's state dict's names and
shapes.  What the port refused until it was ported now builds: the JAX
opt-in environment switches set their config fields, MoE with tensor
parallelism gives the expert-parallel config, and the bench's
`--bf16-residual` samples with a bf16 residual stream."""

import argparse
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dimsum_tpu import cli as jax_cli
from dimsum_tpu.models.factory import create_model as jax_create_model
from dimsum_torch import cli
from dimsum_torch.models.factory import (ENV_SWITCHES, create_model,
                                         env_switches)
from dimsum_torch.utils.convert import state_dict_from_jax_params
from tests.test_torch_convert import torch_one_thread  # noqa: F401

BASE = ["--image-size", "64", "--num-classes", "10", "--label-dropout",
        "0.1"]
ARGVS = {
    "dit": ["--model", "DiT-S/8"],
    "dit-bf16-sigma": ["--model", "DiT-S/4", "--bf16", "--learn-sigma"],
    "moe": ["--model", "DiM-S/2", "--is-moe", "--num-moe-experts", "4",
            "--block-type", "combined", "--bimamba-type", "none",
            "--rms-norm", "--cond-mamba", "--use-attn-every-k-layers", "2"],
    "moe-sinkhorn-glu": ["--model", "DiM-S/2", "--is-moe",
                         "--routing-mode", "sinkhorn",
                         "--gated-linear-unit", "--num-moe-experts", "2"],
    "rope": ["--model", "DiM-S/2", "--pe-type", "rope"],
    "cpe": ["--model", "DiM-S/2", "--pe-type", "cpe", "--block-type",
            "combined", "--bimamba-type", "none"],
    "cond-init": ["--model", "DiM-S/2", "--cond-mamba", "--cond-init",
                  "--bimamba-type", "v2"],
    "mamba-moe-layers": ["--model", "DiM-S/2", "--mamba-moe-layers", "1",
                         "3"],
}


def _parse(module, argv):
    p = argparse.ArgumentParser()
    module.add_model_args(p)
    module.add_moe_args(p)
    return p.parse_args(argv)


@pytest.mark.parametrize("case", list(ARGVS))
def test_create_model_builds_what_jax_builds(case):
    argv = ARGVS[case] + BASE
    jmodel, jcfg = jax_create_model(_parse(jax_cli, argv))
    port, cfg = create_model(_parse(cli, argv), device="cpu")
    assert type(port).__name__ == type(jmodel).__name__
    jfields = {f.name for f in dataclasses.fields(jcfg)}
    shared = [f.name for f in dataclasses.fields(cfg)
              if f.name in jfields and f.name != "dtype"]
    assert len(shared) >= 10
    for name in shared:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert str(cfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,)),
                            jnp.zeros((1,), jnp.int32))
    want = state_dict_from_jax_params(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    got = port.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k


def test_mamba_moe_layers_builds_nothing():
    with_layers = cli.model_config(_parse(
        cli, ARGVS["mamba-moe-layers"] + BASE))
    without = cli.model_config(_parse(cli, ["--model", "DiM-S/2"] + BASE))
    assert with_layers == without


@pytest.mark.parametrize("switch", sorted(ENV_SWITCHES))
def test_unported_switches_raise(switch, monkeypatch):
    """Each JAX opt-in switch, which the port refused until it was
    ported, sets its config field from the environment, for a DiM and
    (the norm and attention ones) for a DiT."""
    field = ENV_SWITCHES[switch]
    on = "1" if field in ("flash_attn", "full_attn") else True
    off = "auto" if on == "1" else False
    base = cli.model_config(_parse(cli, ["--model", "DiM-S/2"] + BASE))
    assert getattr(base, field) == off
    monkeypatch.setenv(switch, "1")
    cfg = cli.model_config(_parse(cli, ["--model", "DiM-S/2"] + BASE))
    assert getattr(cfg, field) == on
    assert dataclasses.replace(cfg, **{field: off}) == base
    dit = cli.model_config(_parse(cli, ARGVS["dit"] + BASE))
    assert getattr(dit, field, off) == (
        on if field in env_switches(dit=True) else off)
    if on == "1":
        monkeypatch.setenv(switch, "0")
        assert getattr(cli.model_config(_parse(
            cli, ["--model", "DiM-S/2"] + BASE)), field) == "0"


def test_moe_with_tensor_parallelism_raises():
    """--is-moe with --tp no longer raises: the config is the MoE one,
    and the CLI's model group (`tp_group`) makes it expert-parallel at
    `moe_capacity_factor`."""
    args = _parse(cli, ["--model", "DiM-S/2", "--is-moe"] + BASE)
    args.tp = 2
    cfg = cli.model_config(args)
    assert cfg.is_moe and cfg.moe_capacity_factor == 2.0
    assert cfg.tp_group is None


def test_bench_refuses_bf16_residual():
    """bench --bf16-residual samples with the residual stream in bf16 (the
    JAX bench's residual_in_fp32=False)."""
    from dimsum_torch.bench import run

    record, out = run(batch=1, steps=2, dtype="bf16", device="cpu",
                      model="DiM-S/2", residual_in_fp32=False)
    assert record["residual_in_fp32"] is False
    assert out.shape == (1, 4, 32, 32) and torch.isfinite(out).all()
