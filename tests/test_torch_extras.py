"""The port's last helper modules against the JAX package's: augment
(bias-gelu, 3-Augment, block noise), eval/image_ops (bias_act, upfirdn2d),
training_stats (the collector, also across 2 gloo ranks), profiling and
the flops CLI.  Inputs from numpy seeds; fp32.

Tolerances: elementwise functions 1e-6 relative (+ 1e-6 absolute: tanh,
exp and the sums round differently in the two libraries); the FIR
convolutions 1e-5 (sums of up to 16 products in another order); the
3-Augment copies and the statistics' moments bit for bit / 1e-12 (the same
numpy code in float64)."""

import json
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import jax
import jax.numpy as jnp

from dimsum_tpu.eval import image_ops as jax_ops
from dimsum_tpu.utils import augment as jax_aug
from dimsum_tpu.utils import profiling as jax_prof
from dimsum_tpu.utils import training_stats as jax_ts
from dimsum_torch.eval import image_ops
from dimsum_torch.utils import augment, profiling, training_stats as ts
from tests.test_torch_convert import torch_one_thread  # noqa: F401
from tests.torch_stats_ranks import stats_rank

RTOL = ATOL = 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ------------------------------- augment ----------------------------------


def test_bias_gelu_and_its_gradient_match_jax():
    rng = np.random.default_rng(0)
    y = (3 * rng.standard_normal((4, 8))).astype(np.float32)
    b = (0.2 * rng.standard_normal(8)).astype(np.float32)
    g = rng.standard_normal((4, 8)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (y, b, g)]
    _close(augment.bias_gelu(t[1], t[0]), jax_aug.bias_gelu(b, y))
    _close(augment.gelu_back(t[2], t[1], t[0]), jax_aug.gelu_back(g, b, y))
    # the hand gradient is autograd's of the forward
    yt = t[0].clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(augment.bias_gelu(t[1], yt), yt, t[2])
    _close(augment.gelu_back(t[2], t[1], t[0]), grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_three_augment_matches_jax_for_the_same_generator(seed):
    img = np.random.default_rng(100 + seed).integers(
        0, 256, (16, 12, 3), dtype=np.uint8)
    got = augment.three_augment(img, np.random.default_rng(seed))
    want = jax_aug.three_augment(img, np.random.default_rng(seed))
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    for fn, args in ((augment.gray_scale, ()), (augment.solarize, (100,)),
                     (augment.gaussian_blur, (1.3,))):
        assert np.array_equal(fn(img, *args),
                              getattr(jax_aug, fn.__name__)(img, *args))


def test_block_noise_blocks_and_std():
    """As test_block_noise_std: unit std; and the block structure: the
    block-2 noise is the four rolls of the block-1 draw from the same
    generator, summed and halved."""
    def gen():
        return torch.Generator().manual_seed(0)

    shape = (4, 1, 32, 32)
    n = augment.block_noise(shape, 2, gen(), device="cpu")
    assert 0.7 < float(n.std()) < 1.3
    g = augment.block_noise(shape, 1, gen(), device="cpu")
    assert g.shape == shape and 0.9 < float(g.std()) < 1.1
    want = sum(torch.roll(g, (px, py), (-2, -1)) for px in range(2)
               for py in range(2)) / 2
    torch.testing.assert_close(n, want, rtol=0, atol=1e-6)
    jax_n = jax_aug.block_noise(jax.random.PRNGKey(0), shape, block_size=2)
    assert 0.7 < float(jnp.std(jax_n)) < 1.3


# ------------------------------- image ops --------------------------------


@pytest.mark.parametrize("act", sorted(jax_ops._ACTS))
def test_bias_act_matches_jax(act):
    rng = np.random.default_rng(1)
    x = (2 * rng.standard_normal((2, 5, 3, 4))).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    for kw in (dict(), dict(alpha=0.1, gain=0.7, clamp=0.9)):
        got = image_ops.bias_act(torch.from_numpy(x), torch.from_numpy(b),
                                 dim=1, act=act, **kw)
        want = jax_ops.bias_act(jnp.asarray(x), jnp.asarray(b), dim=1,
                                act=act, **kw)
        _close(got, want)


@pytest.mark.parametrize("f, kw", [
    ([1, 3, 3, 1], {}), ([1, 1], dict(gain=2.0)),
    ([1, 2, 3, 4, 4, 3, 2, 1], {}), ([[1, 2], [3, 4]], dict(normalize=False)),
    (2.0, {})])
def test_setup_filter_matches_jax(f, kw):
    _close(image_ops.setup_filter(f, device="cpu", **kw),
           jax_ops.setup_filter(f, **kw))


@pytest.mark.parametrize("up, down, padding", [
    (1, 1, 0), (2, 1, 1), (1, 2, (1, 2, 0, 1)), (2, 2, (3, -1, 2, -2)),
    (3, 1, (-1, 2, 1, 0))])
def test_upfirdn2d_matches_jax(up, down, padding):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 9, 7)).astype(np.float32)
    f = np.array(jax_ops.setup_filter([1, 3, 3, 1]))
    got = image_ops.upfirdn2d(torch.from_numpy(x), torch.from_numpy(f),
                              up=up, down=down, padding=padding, gain=1.5)
    want = jax_ops.upfirdn2d(jnp.asarray(x), jnp.asarray(f), up=up,
                             down=down, padding=padding, gain=1.5)
    assert got.shape == want.shape
    _close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("taps", [[1, 3, 3, 1], [1, 1], [1, 2, 1]])
def test_up_and_downsample2d_match_jax(taps):
    x = np.random.default_rng(3).standard_normal(
        (1, 2, 8, 8)).astype(np.float32)
    f = np.array(jax_ops.setup_filter(taps))
    for name in ("upsample2d", "downsample2d"):
        got = getattr(image_ops, name)(torch.from_numpy(x),
                                       torch.from_numpy(f))
        want = getattr(jax_ops, name)(jnp.asarray(x), jnp.asarray(f))
        assert got.shape == want.shape, name
        _close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------- training stats ------------------------------


@pytest.fixture
def clean_stats():
    ts.reset()
    jax_ts.reset()
    yield
    ts.reset()
    jax_ts.reset()


def _feed(mod, vals):
    c = mod.Collector()
    mod.report("loss", vals[:100])
    mod.report("loss", torch.from_numpy(vals[100:]) if mod is ts
               else vals[100:])
    mod.report("lr", 1e-4)
    mod.report0("r0", [5.0])
    mod.report("a/empty", [])
    c.update()
    return c


def test_collector_matches_jax(clean_stats):
    vals = np.random.RandomState(0).randn(257)
    got, want = _feed(ts, vals), _feed(jax_ts, vals)
    assert got.names() == want.names()
    for name in want.names():
        assert got.num(name) == want.num(name)
        for k in ("mean", "std"):
            a, b = getattr(got, k)(name), getattr(want, k)(name)
            assert (np.isnan(a) and np.isnan(b)) or a == pytest.approx(
                b, rel=1e-12), (name, k)
    assert got.as_dict().keys() == want.as_dict().keys()
    np.testing.assert_allclose(got.mean("loss"), vals.mean(), rtol=1e-12)


def test_collector_windowing_and_regex(clean_stats):
    c = ts.Collector(regex="x.*", keep_previous=True)
    ts.report("x", [1.0, 3.0])
    ts.report("y", [7.0])
    c.update()
    assert c.names() == ["x"] and c.mean("x") == 2.0
    c.update()
    assert c.mean("x") == 2.0 and c.num("x") == 2
    ts.report("x", [10.0])
    c.update()
    assert c.mean("x") == 10.0 and c.num("x") == 1 and c["x"] == 10.0


def test_moments_match_jax_and_report(clean_stats):
    v = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    got = ts.moments(torch.from_numpy(v))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    _close(got, jax_ts.moments(jnp.asarray(v)), rtol=1e-6, atol=1e-5)
    c = ts.Collector()
    ts.report_moments("graph", got)
    ts.report("host", v)
    c.update()
    assert c.num("graph") == c.num("host") == 20
    np.testing.assert_allclose(c.mean("graph"), c.mean("host"), rtol=1e-6)
    np.testing.assert_allclose(c.std("graph"), c.std("host"), rtol=1e-5)


def test_collector_all_reduces_over_two_gloo_ranks(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(stats_rank, args=(2, port, str(tmp_path)),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + 120
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "ranks still running"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    vals = np.arange(6, dtype=np.float64)
    for r in range(2):
        got = json.load(open(tmp_path / f"rank{r}.json"))
        assert got["loss"][0] == 6
        assert got["loss"][1] == pytest.approx(vals.mean(), rel=1e-12)
        assert got["loss"][2] == pytest.approx(vals.std(), rel=1e-9)
        assert got["lr"] == [1, 0.5, 0.0]  # rank 0's report only


# ------------------------------- profiling --------------------------------


def test_metric_logger_matches_jax():
    got, want = profiling.MetricLogger(window=3), jax_prof.MetricLogger(
        window=3)
    for i in range(40):
        for lg in (got, want):
            lg.update(loss=np.sin(i), step=i)
    for k in ("loss", "step"):
        assert got.mean(k) == want.mean(k)
        assert got.global_mean(k) == want.global_mean(k)
    assert str(got) == str(want)
    assert np.isnan(got.mean("absent"))


def test_flops_counts_two_m_n_k_and_timed_runs(tmp_path):
    lin = torch.nn.Linear(12, 5)
    x = torch.randn(7, 12)
    assert profiling.flops(lin, x) == 2 * 7 * 12 * 5
    assert profiling.timed(lin, x, iters=3) > 0
    profiling.sync(lin(x))  # CPU tensors: nothing to wait for
    with profiling.trace(str(tmp_path)):
        lin(x)
    assert any(f.endswith(".json") for _, _, fs in os.walk(tmp_path)
               for f in fs)


# ------------------------------- flops CLI --------------------------------


def _matmul_flops(fn, *args):
    """2 m n k summed over every matrix product the call runs (mm, addmm,
    bmm, baddbmm, matmul through them), counted from the operands' shapes
    by a dispatch mode of its own."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    total = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in (aten.mm.default, aten.addmm.default,
                        aten.bmm.default, aten.baddbmm.default):
                a, b = (args[1], args[2]) if func in (
                    aten.addmm.default, aten.baddbmm.default) else args[:2]
                batch = a.shape[0] if a.ndim == 3 else 1
                total[0] += 2 * batch * a.shape[-2] * a.shape[-1] \
                    * b.shape[-1]
                return func(*args, **kwargs)
            assert "convolution" not in str(func), func
            with self:  # composite ops (linear, matmul) into the above
                out = func.decompose(*args, **kwargs)
            return func(*args, **kwargs) if out is NotImplemented else out

    with Count():
        fn(*args)
    return total[0]


def test_flops_cli_params_and_gflops():
    """A tiny DiM (DiM-S/2 at 64 px): the CLI's params_M is the JAX model's
    parameter count; its operations are 2 m n k over the forward's matrix
    products (the plain routes); the JAX script's keys."""
    from dimsum_tpu.models.dim import DiM, DiM_models
    from dimsum_torch import flops as cli

    out = cli.main(["--model", "DiM-S/2", "--image-size", "64",
                    "--device", "cpu", "--measure-throughput"])
    assert set(out) >= {"model", "params_M", "forward_gflops",
                        "peak_bytes_GB", "forward_ms", "img_per_sec",
                        "achieved_tflops"}
    jcfg = DiM_models["DiM-S/2"](img_resolution=8, num_classes=1000,
                                 rms_norm=True, block_type="combined",
                                 cond_mamba=True, learnable_pe=True,
                                 use_attn_every_k_layers=4)
    shapes = jax.eval_shape(DiM(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,)),
                            jnp.zeros((1,), jnp.int32))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    cfg, model = cli.build("DiM-S/2", 64, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert out["params_M"] == round(n_jax / 1e6, 2)
    x = torch.zeros(1, 4, 8, 8)
    t, y = torch.zeros(1), torch.zeros(1, dtype=torch.long)
    with torch.inference_mode(), cli.plain_routes(model):
        counted = profiling.flops(model, x, t, y)
        assert counted == _matmul_flops(model, x, t, y) > 0
    assert out["forward_gflops"] == round(counted / 1e9, 2)
