"""The port's training slice against the JAX package on a tiny DiM (hidden
64, depth 4, a shared DiT block after every 2nd block, grid 16 so the
frequency half takes the 256-px wavelet route), with the JAX weights
carried across by `state_dict_from_jax_params`:

  * label dropout and stochastic depth on their own;
  * the flow-matching loss and every parameter's gradient against
    `jax.value_and_grad`, with the draws injected so that both packages see
    the same t, x0, label-drop ids and drop-path masks;
  * one whole train step (clip, AdamW, EMA) against the JAX
    `clip_by_global_norm`, `create_optimizer` and `ema_update` composed as
    the JAX `make_train_step` composes them;
  * grad_accum 2 against the monolithic step;
  * the training bench end to end on the CPU.

Injection: the transport's `sample` returns fixed (t, x0) rows, the model
gets fixed `force_drop_ids`, and each package's `drop_path_fn` is replaced
by one that hands out fixed per-sample masks in call order (blocks 2 and 3,
the ones with a nonzero rate).

Tolerances, fp32: the JAX CPU route scans with an associative scan, the
port sequentially, so values differ by ~1e-6 relative per mixer.  Loss
1e-5 relative (measured 7e-8); gradients 1e-3 of each tensor's largest
value (measured <= 7e-6); after a step from the same gradients, each
parameter and its EMA to 1e-4 of lr plus two fp32 rounding steps of the
stored value.

bf16 (computed in bf16 over fp32 weights, the training protocol's
precision): the two packages round at different places; the JAX route
expands dt = dt_low @ dt_w in bf16, the port in fp32 (kept by design).
Loss 2e-3 relative (measured 5e-4), each gradient 0.1 of its scale
(measured <= 0.057, the dt_proj and x_proj gradients of the last block
the furthest); and, against the fp32 gradients, the port's bf16 ones no
further than 1.5x JAX's own bf16 ones (measured 0.10 against 0.16)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

import dimsum_tpu.models.blocks as jax_blocks
import dimsum_torch.models.blocks as port_blocks
from dimsum_tpu.models.dim import DiM as JaxDiM
from dimsum_tpu.models.dim import DiMConfig as JaxDiMConfig
from dimsum_tpu.models.embedders import LabelEmbedder as JaxLabelEmbedder
from dimsum_tpu.parallel.train import clip_by_global_norm as jax_clip
from dimsum_tpu.parallel.train import create_optimizer as jax_optimizer
from dimsum_tpu.parallel.train import ema_update as jax_ema
from dimsum_tpu.transport import create_transport as jax_transport
from dimsum_tpu.transport.transport import Transport as JaxTransport
from dimsum_tpu.utils.ckpt import convert_torch_state_dict
from dimsum_torch.models.dim import DiM, DiMConfig, build_dim
from dimsum_torch.models.embedders import LabelEmbedder
from dimsum_torch.parallel import (create_optimizer, create_train_state,
                                   make_train_step)
from dimsum_torch.transport import create_transport
from dimsum_torch.transport.transport import Transport
from dimsum_torch.utils.convert import state_dict_from_jax_params
from tests.test_torch_convert import (PUBLISHED, randomize,  # noqa: F401
                                     torch_one_thread)

TINY = dict(img_resolution=32, hidden_size=64, depth=4,
            use_attn_every_k_layers=2, num_classes=10, label_dropout=0.1)
N = 3
LR = 1e-4
MASKS = np.array([[1, 0, 1], [0, 1, 1]], np.float32)  # blocks 2 and 3
DROP_IDS = np.array([0, 1, 0], np.int32)


def _draws(seed, n=N):
    rng = np.random.default_rng(seed)
    x1 = rng.standard_normal((n, 4, 32, 32)).astype(np.float32)
    x0 = rng.standard_normal((n, 4, 32, 32)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, n).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x1, x0, t, y


@dataclasses.dataclass(frozen=True)
class FixedDraws(Transport):
    """The port's transport with `sample` handing out fixed (t, x0) rows in
    order, across calls (a micro-batch takes the next rows)."""
    rows: list = dataclasses.field(default_factory=list)

    def sample(self, x1, generator=None):
        n = x1.shape[0]
        t, x0 = self.rows[0][:n], self.rows[1][:n]
        self.rows[:] = [self.rows[0][n:], self.rows[1][n:]]
        return t, x0, x1


@dataclasses.dataclass(frozen=True)
class FixedDropIds(FixedDraws):
    """FixedDraws that also passes fixed label-drop ids to the model."""
    force_drop_ids: object = None

    def training_losses(self, model_fn, x1, generator=None,
                        model_kwargs=None):
        kw = dict(model_kwargs or {}, force_drop_ids=self.force_drop_ids)
        return super().training_losses(model_fn, x1, generator, kw)


def fixed_transport(t, x0, force_drop_ids=None):
    base = create_transport("GVP", "velocity")
    fields = {f.name: getattr(base, f.name)
              for f in dataclasses.fields(Transport)}
    rows = [torch.from_numpy(t), torch.from_numpy(x0)]
    if force_drop_ids is None:
        return FixedDraws(**fields, rows=rows)
    return FixedDropIds(**fields, rows=rows,
                        force_drop_ids=torch.from_numpy(force_drop_ids))


def _patch_drop_path(monkeypatch, module, masks, to_array):
    """Replace `module.drop_path_fn` by fixed masks, one per call."""
    calls = []

    def fixed(x, rate, rng):
        mask = to_array(masks[len(calls)]).reshape(
            (x.shape[0],) + (1,) * (x.ndim - 1))
        calls.append(rate)
        return x * (mask.astype(x.dtype) if hasattr(mask, "astype")
                    else mask.to(x.dtype)) / (1.0 - rate)

    monkeypatch.setattr(module, "drop_path_fn", fixed)
    return calls


def _patch_jax_sample(monkeypatch, t, x0):
    monkeypatch.setattr(JaxTransport, "sample",
                        lambda self, rng, x1: (jnp.asarray(t),
                                               jnp.asarray(x0), x1))


def tiny_models(seed=0, drop_path=0.2):
    jmodel = JaxDiM(JaxDiMConfig(**TINY, **PUBLISHED, drop_path=drop_path))
    z = jnp.zeros((2, 4, 32, 32))
    params = randomize(jax.jit(jmodel.init)(
        jax.random.PRNGKey(seed), z, jnp.zeros((2,)),
        jnp.zeros((2,), jnp.int32)), seed)
    port = DiM(DiMConfig(**TINY, drop_path=drop_path))
    port.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jmodel, params, port.train()


def _grads_by_name(model):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            for n, p in model.named_parameters()}


def _assert_scaled(got, want, tol, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


# --------------------------------------------------------------------------
# label dropout and stochastic depth on their own
# --------------------------------------------------------------------------

def test_label_dropout_force_ids_match_jax():
    table = JaxLabelEmbedder(10, 8, 0.1)
    labels = np.arange(6, dtype=np.int32)
    force = np.array([1, 0, 1, 0, 0, 1], np.int32)
    params = table.init(jax.random.PRNGKey(0), labels)
    want = table.apply(params, labels, train=True, force_drop_ids=force)
    port = LabelEmbedder(10, 8, 0.1)
    port.load_state_dict(state_dict_from_jax_params(params))
    got = port(torch.from_numpy(labels).long(), train=True,
               force_drop_ids=torch.from_numpy(force))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    # the dropped rows are the null class, index num_classes
    torch.testing.assert_close(got[0], port.embedding_table.weight[10])


def test_label_dropout_draws():
    port = LabelEmbedder(10, 4, 0.25)
    labels = torch.arange(10).repeat(400)
    g = torch.Generator().manual_seed(0)
    out = port(labels, train=True, generator=g)
    dropped = (out == port.embedding_table.weight[10]).all(-1)
    assert abs(dropped.float().mean().item() - 0.25) < 0.03
    # not in training, and never with dropout_prob 0
    torch.testing.assert_close(port(labels), port.embedding_table(labels))
    plain = LabelEmbedder(10, 4, 0.0)
    assert plain.embedding_table.num_embeddings == 10
    torch.testing.assert_close(plain(labels, train=True, generator=g),
                               plain.embedding_table(labels))


def test_drop_path_fn_keeps_and_scales_whole_samples():
    x = torch.ones(4000, 3, 5)
    out = port_blocks.drop_path_fn(x, 0.3, torch.Generator().manual_seed(1))
    per_sample = out.reshape(4000, -1)
    kept = per_sample[:, 0] > 0
    assert (per_sample[kept] == 1 / 0.7).all()
    assert (per_sample[~kept] == 0).all()
    assert abs(kept.float().mean().item() - 0.7) < 0.03


def test_drop_path_only_in_training_and_with_a_residual():
    torch.manual_seed(0)
    block = port_blocks.DiMBlockCombined(64, d_cond=64, drop_path_rate=0.5)
    x = torch.randn(8, 256, 64)
    res = torch.randn(8, 256, 64)
    c = torch.randn(8, 64)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        ref = block(x, res, c)
        torch.testing.assert_close(block(x, None, c, train=True,
                                         generator=g), block(x, None, c))
        out, _ = block(x, res, c, train=True, generator=g)
        zero, _ = block(torch.zeros_like(x), res, c)
        twice, _ = block(2 * x, res, c)
    for i in range(8):
        assert (torch.allclose(out[i], zero[i], atol=1e-5)
                or torch.allclose(out[i], twice[i], atol=1e-5))
    assert not torch.allclose(out, ref[0])


def test_drop_path_rates_match_jax():
    cfg = JaxDiMConfig(**TINY, **PUBLISHED, drop_path=0.3)
    inter_dpr, _ = JaxDiM._drop_path_rates(cfg)
    port = DiM(DiMConfig(**TINY, drop_path=0.3))
    got = [b.drop_path_rate for b in port.blocks]
    np.testing.assert_allclose(got, inter_dpr[:4], rtol=0, atol=1e-12)


# --------------------------------------------------------------------------
# the transport's training draws and loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["uniform", "logitnormal"])
def test_training_draws(mode):
    tr = create_transport("GVP", "velocity", t_sample_mode=mode)
    x1 = torch.randn(4000, 2, 2)
    t, x0, same = tr.sample(x1, torch.Generator().manual_seed(0))
    assert same is x1 and x0.shape == x1.shape and t.shape == (4000,)
    assert t.dtype == torch.float32 and 0 <= t.min() and t.max() <= 1
    assert abs(x0.std().item() - 1) < 0.03
    mean = 0.5 if mode == "uniform" else 0.4
    assert abs(t.mean().item() - mean) < 0.03


def test_plan_matches_jax():
    x1, x0, t, _ = _draws(0)
    _, want_xt, want_ut = jax_transport("GVP", "velocity").path_sampler.plan(
        t, x0, x1)
    _, xt, ut = create_transport("GVP", "velocity").path_sampler.plan(
        torch.from_numpy(t), torch.from_numpy(x0), torch.from_numpy(x1))
    np.testing.assert_allclose(xt.numpy(), np.asarray(want_xt), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ut.numpy(), np.asarray(want_ut), rtol=1e-6,
                               atol=1e-6)


# --------------------------------------------------------------------------
# the tiny DiM: loss and gradients, one step, grad accumulation
# --------------------------------------------------------------------------

def _jax_loss_and_grads(jmodel, params):
    """The loss and gradients through `jax.value_and_grad` of the JAX
    transport's training loss, with the draws, label-drop ids and drop-path
    masks injected."""
    x1, x0, t, y = _draws(1)
    jtr = jax_transport("GVP", "velocity")

    def loss_fn(p):
        def model_fn(xt, t_, **kw):
            return jmodel.apply(p, xt, t_, train=True,
                                rngs={"drop_path": jax.random.PRNGKey(9),
                                      "label_dropout":
                                          jax.random.PRNGKey(9)}, **kw)
        terms = jtr.training_losses(model_fn, jax.random.PRNGKey(0), x1,
                                    {"y": y, "force_drop_ids": DROP_IDS})
        return terms["loss"].mean()

    with pytest.MonkeyPatch.context() as mp:
        _patch_jax_sample(mp, t, x0)
        calls = _patch_drop_path(mp, jax_blocks, MASKS, jnp.asarray)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return dict(params=params, loss=float(loss), grads=grads, calls=calls,
                draws=(x1, x0, t, y))


@pytest.fixture(scope="module")
def jax_reference():
    """The tiny DiM's JAX params, and its fp32 loss and gradients."""
    jmodel, params, _ = tiny_models(seed=0)
    return _jax_loss_and_grads(jmodel, params)


@pytest.fixture(scope="module")
def jax_reference_bf16(jax_reference):
    """The same params, loss and gradients with the model computing in
    bf16 (the params stay fp32)."""
    jmodel = JaxDiM(JaxDiMConfig(**TINY, **PUBLISHED, drop_path=0.2,
                                 dtype=jnp.bfloat16))
    return _jax_loss_and_grads(jmodel, jax_reference["params"])


def _port_with_draws(monkeypatch, ref, dtype=torch.float32):
    """The port's tiny DiM (computing in `dtype`) with the reference's
    weights, its transport handing out the same (t, x0) and label-drop ids,
    and its drop-path masks patched."""
    x1, x0, t, y = ref["draws"]
    port = DiM(DiMConfig(**TINY, drop_path=0.2, dtype=dtype))
    port.load_state_dict(state_dict_from_jax_params(ref["params"]),
                         strict=True)
    calls = _patch_drop_path(monkeypatch, port_blocks, MASKS,
                             torch.from_numpy)
    tr = fixed_transport(t, x0, force_drop_ids=DROP_IDS)
    return port.train(), tr, calls


def test_tiny_dim_loss_and_grads_match_jax(monkeypatch, jax_reference):
    ref = jax_reference
    port, tr, calls = _port_with_draws(monkeypatch, ref)
    x1, _, _, y = ref["draws"]
    terms = tr.training_losses(
        lambda xt, t_, **kw: port(xt, t_, train=True, **kw),
        torch.from_numpy(x1), None, {"y": torch.from_numpy(y).long()})
    loss = terms["loss"].mean()
    loss.backward()

    assert ref["calls"] == pytest.approx([0.2 / 3, 0.4 / 3])
    assert calls == pytest.approx(ref["calls"])
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    want = state_dict_from_jax_params(ref["grads"])
    got = _grads_by_name(port)
    assert set(got) == set(want)
    for name in sorted(want):
        _assert_scaled(got[name].numpy(), want[name].numpy(), 1e-3, name)
    # CondMamba's cond_proj stays out of the graph in both packages
    assert port.blocks[0].spatial_mamba.mixer.cond_proj.weight.grad is None
    assert not want["blocks.0.spatial_mamba.mixer.cond_proj.weight"].any()


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_tiny_dim_bf16_loss_and_grads_match_jax(monkeypatch, jax_reference,
                                                jax_reference_bf16):
    """The loss and every gradient of the tiny DiM computing in bf16 over
    fp32 weights, against `jax.value_and_grad` of the JAX model in bf16 on
    the same weights and draws; both held to the fp32 gradients too."""
    ref, ref16 = jax_reference, jax_reference_bf16
    port, tr, calls = _port_with_draws(monkeypatch, ref, torch.bfloat16)
    x1, _, _, y = ref["draws"]
    loss = tr.training_losses(
        lambda xt, t_, **kw: port(xt, t_, train=True, **kw),
        torch.from_numpy(x1), None,
        {"y": torch.from_numpy(y).long()})["loss"].mean()
    loss.backward()

    assert calls == pytest.approx(ref16["calls"])
    np.testing.assert_allclose(loss.item(), ref16["loss"], rtol=2e-3)
    want16 = state_dict_from_jax_params(ref16["grads"])
    want32 = state_dict_from_jax_params(ref["grads"])
    got = _grads_by_name(port)
    assert set(got) == set(want16)
    port_err, jax_err = [], []
    for name in sorted(want16):
        assert got[name].dtype == torch.float32, name
        g = got[name].numpy()
        _assert_scaled(g, want16[name].numpy(), 0.1, name)
        port_err.append(_scaled_err(g, want32[name].numpy()))
        jax_err.append(_scaled_err(want16[name].numpy(),
                                   want32[name].numpy()))
    # bf16 rounding, not a divergence: the port's bf16 gradients are no
    # further from the fp32 ones than JAX's own bf16 gradients, with margin
    assert max(port_err) <= 1.5 * max(jax_err)


def test_one_train_step_matches_jax(monkeypatch, jax_reference):
    """The port's `make_train_step` against the JAX package's
    `clip_by_global_norm`, `create_optimizer` (optax AdamW) and `ema_update`
    composed as its `make_train_step` composes them.  The JAX side takes
    the port's own gradients of the same loss (the step's arithmetic is the
    claim here; the gradients are held to JAX's above), so the updates
    agree to rounding, including entries whose gradient is near Adam's
    eps.  The step's loss and norm are also held to the JAX reference's.
    max_grad_norm 0.5 (below this gradient's norm, so the clip acts) and
    EMA decay 0.5 (so the EMA visibly moves)."""
    ref = jax_reference
    x1, _, _, y = ref["draws"]
    port, tr, _ = _port_with_draws(monkeypatch, ref)
    loss = tr.training_losses(
        lambda xt, t_, **kw: port(xt, t_, train=True, **kw),
        torch.from_numpy(x1), None,
        {"y": torch.from_numpy(y).long()})["loss"].mean()
    loss.backward()
    jparams = ref["params"]["params"]
    jgrads = convert_torch_state_dict(
        {n: g.numpy() for n, g in _grads_by_name(port).items()}, jparams,
        strict=True)

    @jax.jit
    def jax_step(params, grads):
        clipped, norm = jax_clip(grads, 0.5)
        opt = jax_optimizer(LR, weight_decay=0.0)
        updates, _ = opt.update(clipped, opt.init(params), params)
        new = optax.apply_updates(params, updates)
        return new, jax_ema(params, new, 0.5), norm

    new_params, new_ema, jnorm = jax_step(jparams, jgrads)

    port, tr, _ = _port_with_draws(monkeypatch, ref)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    opt = create_optimizer(port, lr=LR)
    state = create_train_state(port, opt)
    step = make_train_step(port, tr, opt, max_grad_norm=0.5, ema_decay=0.5)
    m = step(state, torch.from_numpy(x1), torch.from_numpy(y).long(),
             torch.Generator().manual_seed(0))

    assert state.step == 1
    np.testing.assert_allclose(m["loss"].item(), ref["loss"], rtol=1e-5)
    ref_norm = float(optax.global_norm(ref["grads"]))
    np.testing.assert_allclose(m["grad_norm"].item(), ref_norm, rtol=1e-4)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jnorm),
                               rtol=1e-6)
    assert m["grad_norm"].item() > 0.5
    want_p = state_dict_from_jax_params(new_params)
    want_e = state_dict_from_jax_params(new_ema)
    for name, p in port.named_parameters():
        # an update (~lr) to 1e-4 of lr, plus the stored value's rounding
        b = before[name].numpy()
        tol = 1e-4 * LR + 2 * np.spacing(np.abs(b))
        diff = np.abs(p.detach().numpy() - want_p[name].numpy())
        assert (diff <= tol).all(), name
        diff = np.abs(state.ema_params[name].numpy() - want_e[name].numpy())
        assert (diff <= tol).all(), name
        assert not np.isnan(diff).any()
    # no gradient, no change: cond_proj, and the label rows left unused
    cp = "blocks.1.freq_mamba.mixer.cond_proj.weight"
    assert torch.equal(dict(port.named_parameters())[cp], before[cp])
    used = set(np.where(DROP_IDS == 1, 10, y).tolist())
    table = port.y_embedder.embedding_table.weight.detach()
    old = before["y_embedder.embedding_table.weight"]
    for row in range(11):
        assert torch.equal(table[row], old[row]) == (row not in used), row


def test_grad_accum_equals_the_monolithic_step():
    """The same four samples and draws, as one batch and as two
    micro-batches of two; no stochastic depth, labels off.  The loss, the
    norm and every gradient agree to summation order (1e-5 of scale); the
    update is the same function of the gradient either way."""
    x1, x0, t, _ = _draws(4, n=4)
    results = []
    for accum in (1, 2):
        port = build_dim(DiMConfig(**TINY), "cpu", seed=3, train=True)
        opt = create_optimizer(port, lr=LR)
        state = create_train_state(port, opt)
        step = make_train_step(port, fixed_transport(t, x0), opt,
                               use_labels=False, grad_accum=accum)
        m = step(state, torch.from_numpy(x1), None,
                 torch.Generator().manual_seed(0))
        results.append((m, dict(port.named_parameters())))
    (m1, p1), (m2, p2) = results
    torch.testing.assert_close(m2["loss"], m1["loss"], rtol=1e-6, atol=0)
    torch.testing.assert_close(m2["grad_norm"], m1["grad_norm"], rtol=1e-5,
                               atol=0)
    # the (clipped) gradients each update took: the sums differ in order
    for name in p1:
        g1, g2 = p1[name].grad, p2[name].grad
        if g1 is None:
            assert g2 is None, name
            continue
        _assert_scaled(g2.numpy(), g1.numpy(), 1e-5, name)


def test_train_bench_runs_on_cpu():
    """`train_bench.run` end to end, on the CPU only because the caller
    asks for it, with a narrow model: finite losses, and the parameters and
    their EMA move."""
    from dimsum_torch.train_bench import run

    record, state = run(model="DiM-S/2", batch=2, steps=1, warmup=1,
                        device="cpu")
    assert record["device"] == "cpu" and record["value"] > 0
    assert len(record["loss"]) == 2 and np.isfinite(record["loss"]).all()
    assert np.isfinite(record["grad_norm"]).all()
    p = state.model.x_embedder.proj.weight
    assert p.dtype == torch.float32
    assert not torch.equal(state.ema_params["x_embedder.proj.weight"],
                           p.detach())


class _ForcedDrops:
    """A JAX model whose `apply` always takes the fixed label-drop ids, so
    the JAX `make_train_step` (which passes only y) drops the same rows."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, xt, t, **kw):
        return self.model.apply(variables, xt, t,
                                force_drop_ids=DROP_IDS, **kw)


def test_train_step_with_weight_decay_matches_jax(monkeypatch,
                                                  jax_reference):
    """One step at lr 1e-2 and weight decay 0.1 through the port's
    `make_train_step` against the JAX `make_train_step` (optax AdamW, which
    steps every parameter): the parameters that take no gradient
    (CondMamba's cond_proj, the unused label rows) decay by lr * wd in
    both, to two fp32 rounding steps.  Every other entry whose gradient is
    above 1e-3 of its tensor's scale, where Adam's first step g / (|g| +
    eps) does not hang on the last digits of g, agrees to 1e-4 of lr plus
    two rounding steps; the rest (Adam normalizes a near-zero gradient to
    anything up to +-lr) within 2 lr.  The EMA (decay 0.5) likewise."""
    from dimsum_tpu.parallel.train import create_train_state as jax_state
    from dimsum_tpu.parallel.train import make_train_step as jax_make_step

    lr, wd = 1e-2, 0.1
    ref = jax_reference
    x1, x0, t, y = ref["draws"]
    jparams = ref["params"]["params"]
    jmodel = JaxDiM(JaxDiMConfig(**TINY, **PUBLISHED, drop_path=0.2))
    with pytest.MonkeyPatch.context() as mp:
        _patch_jax_sample(mp, t, x0)
        _patch_drop_path(mp, jax_blocks, MASKS, jnp.asarray)
        jstep = jax_make_step(_ForcedDrops(jmodel),
                              jax_transport("GVP", "velocity"),
                              jax_optimizer(lr, weight_decay=wd),
                              max_grad_norm=0.5, ema_decay=0.5)
        jstate, jm = jstep(jax_state(jparams, jax_optimizer(
            lr, weight_decay=wd)), x1, y, jax.random.PRNGKey(0))
    want_p = state_dict_from_jax_params(jstate.params)
    want_e = state_dict_from_jax_params(jstate.ema_params)
    jgrads = state_dict_from_jax_params(ref["grads"])

    port, tr, _ = _port_with_draws(monkeypatch, ref)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    opt = create_optimizer(port, lr=lr, weight_decay=wd)
    state = create_train_state(port, opt)
    step = make_train_step(port, tr, opt, max_grad_norm=0.5, ema_decay=0.5)
    m = step(state, torch.from_numpy(x1), torch.from_numpy(y).long(),
             torch.Generator().manual_seed(0))

    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(),
                               float(jm["grad_norm"]), rtol=1e-4)
    cp = "blocks.1.freq_mamba.mixer.cond_proj.weight"
    decayed = 0
    for name, p in port.named_parameters():
        b = before[name].numpy()
        g = jgrads[name].numpy()
        rounding = 2 * np.spacing(np.abs(b))
        tight = np.abs(g) > 1e-3 * max(np.abs(g).max(), 1e-30)
        tol = np.where(tight, 1e-4 * lr, 2 * lr) + rounding
        for got, want in ((p.detach().numpy(), want_p[name].numpy()),
                          (state.ema_params[name].numpy(),
                           want_e[name].numpy())):
            diff = np.abs(got - want)
            assert (diff <= tol).all(), name
        # no gradient in either package: the decay alone
        still = (g == 0) & (p.grad.numpy() == 0)
        np.testing.assert_allclose(
            p.detach().numpy()[still], (b * (1 - lr * wd))[still],
            rtol=0, atol=0 if not still.any() else
            2 * np.spacing(np.abs(b[still])).max(), err_msg=name)
        decayed += int(still.sum())
    assert not torch.equal(dict(port.named_parameters())[cp], before[cp])
    assert decayed >= port.blocks[0].spatial_mamba.mixer.cond_proj.weight \
        .numel()
