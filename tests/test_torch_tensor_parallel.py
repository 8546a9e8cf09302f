"""The port's parallelism beyond DDP against the JAX package on the CPU:
tensor parallelism (TP: a train step, a sampling forward) and expert
parallelism (EP: `switch_ep` against `switch_ep_gspmd`), with the
state-dict sharding that saves and loads them (pipeline parallelism:
tests/test_torch_pipeline_parallel.py).

The port's ranks are 2 spawned processes joined by gloo over a `file://`
store under the test's tmp_path, one PyTorch thread each (the pattern of
`tests/test_torch_seq_parallel.py`); the JAX side runs in the test's own
process on its 8 virtual CPU devices (`tests/conftest.py`), unsharded and
under its own shardings.  This module is imported by every spawned rank,
so it imports neither JAX nor the JAX package at its top.

Tolerances, fp32.  The train step: the loss at rtol 1e-5 and every updated
parameter at atol 5e-6 / rtol 1e-4, the JAX package's own for its TP step
against the unsharded one (tests/test_parallel.py:249-287).  The TP
forward 1e-5 of scale (the port's unsharded forward against JAX is held to
the same); EP atol / rtol 1e-5 (tests/test_parallel.py's EP tests).  The
replicated
parameters' gradients are equal across the model group bit for bit: both
ranks compute them from the same all-gathered sums.
"""

import datetime
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dimsum_torch.models.dim import DiM, DiMConfig
from dimsum_torch.parallel import (gather_state_dict, make_mesh_groups,
                                   shard_state_dict)
from dimsum_torch.parallel.mesh import is_sharded, tp_rule

K = 2          # ranks
TIMEOUT = 150  # seconds for a group of ranks, start-up included
# tests/test_parallel.py::tiny_model, with no label dropout (its draw is
# the JAX step's own key) in the port's spelling
TINY = dict(img_resolution=8, patch_size=2, in_channels=4, hidden_size=32,
            depth=2, num_classes=10, label_dropout=0.0, rms_norm=True,
            block_type="combined", cond_mamba=True,
            use_attn_every_k_layers=2, learnable_pe=True)
LR, CLIP, EMA = 1e-2, 1.0, 0.5
N = 4


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """One PyTorch intra-op thread (`tests/test_torch_convert.py::
    torch_one_thread`, which imports JAX)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def _rank(r, fn, k, store, *args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=k, rank=r,
                            timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        fn(r, k, *args)
    finally:
        dist.destroy_process_group()


def _spawn(fn, tmp_path, *args, k=K):
    """fn(rank, k, *args) in k spawned ranks; raises if one fails or the
    group outlives TIMEOUT."""
    ctx = mp.start_processes(_rank, args=(fn, k, str(tmp_path / "store"),
                                          *args),
                             nprocs=k, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__}: ranks still running "
                                   f"after {TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tp_model(path, cfg_kw, group, **extra):
    """The tiny DiM with the model group's shards of the saved weights."""
    full = torch.load(path / "full.pt")
    model = DiM(DiMConfig(**cfg_kw, tp_group=group, **extra))
    model.load_state_dict(shard_state_dict(full, dist.get_rank(group),
                                           dist.get_world_size(group)),
                          strict=True)
    return model


def _fixed_transport(t, x0):
    """The port's GVP transport whose `sample` hands out fixed (t, x0), as
    the JAX step's patched `sample` does."""
    import dataclasses

    from dimsum_torch.transport import create_transport
    from dimsum_torch.transport.transport import Transport

    @dataclasses.dataclass(frozen=True)
    class Fixed(Transport):
        def sample(self, x1, generator=None):
            return t, x0, x1

    base = create_transport("GVP", "velocity")
    return Fixed(**{f.name: getattr(base, f.name)
                    for f in dataclasses.fields(Transport)})


def _train_rank(r, k, path, is_moe):
    from dimsum_torch.parallel import (create_optimizer, create_train_state,
                                       make_train_step)

    d = dict(np.load(path / "draws.npz"))
    g = make_mesh_groups(1, k).model
    extra = dict(is_moe=True, moe_capacity_factor=8.0) if is_moe else {}
    model = _tp_model(path, TINY, g, **extra).train()
    tr = _fixed_transport(_t(d["t"]), _t(d["x0"]))
    opt = create_optimizer(model, lr=LR)
    state = create_train_state(model, opt)
    step = make_train_step(model, tr, opt, max_grad_norm=CLIP,
                           ema_decay=EMA, tp_group=g)
    m = step(state, _t(d["x1"]), _t(d["y"]).long())
    rep = {n: p.grad.numpy() for n, p in model.named_parameters()
           if not is_sharded(n)}
    np.savez(path / f"grads{r}.npz", **rep)
    params = gather_state_dict(model.state_dict(), g)
    ema = gather_state_dict(state.ema_params, g)
    grads = gather_state_dict({n: p.grad for n, p in
                               model.named_parameters()}, g)
    if r == 0:
        np.savez(path / "grads.npz", **{n: v.numpy()
                                        for n, v in grads.items()})
        np.savez(path / "params.npz", **{n: v.numpy()
                                         for n, v in params.items()})
        np.savez(path / "ema.npz", **{n: v.numpy() for n, v in ema.items()})
        np.save(path / "metrics.npy", np.asarray(
            [m["loss"].item(), m["grad_norm"].item()]))


def _forward_rank(r, k, path):
    inp = dict(np.load(path / "inputs.npz"))
    g = make_mesh_groups(1, k).model
    for i, switches in enumerate(FORWARD_SWITCHES):
        model = _tp_model(path, dict(TINY, label_dropout=0.1), g,
                          **switches).eval()
        with torch.no_grad():
            out = model(_t(inp["x"]), _t(inp["t"]), _t(inp["y"]).long())
        np.save(path / f"out{r}_{i}.npy", out.numpy())
    from dimsum_torch.models.dit import DiT, DiTConfig

    dit = DiT(DiTConfig(**DIT_CFG, tp_group=g))  # heads 4 a rank
    dit.load_state_dict(shard_state_dict(torch.load(path / "dit.pt"), r, k),
                        strict=True)
    with torch.no_grad():
        out = dit.eval()(_t(inp["x"]), _t(inp["t"]), _t(inp["y"]).long())
    np.save(path / f"dit{r}.npy", out.numpy())


def _ep_rank(r, k, path, cf):
    from dimsum_torch.models.blocks import SwitchMLP

    x = np.load(path / "x.npy")
    g = make_mesh_groups(1, k).model
    mlp = SwitchMLP(x.shape[-1], 8, capacity_factor=cf, tp_group=g)
    full = torch.load(path / "switch.pt")
    mlp.load_state_dict(shard_state_dict(full, r, k), strict=True)
    assert sorted(mlp.local_experts) == [str(e) for e in
                                         range(4 * r, 4 * r + 4)]
    with torch.no_grad():
        np.save(path / f"out{r}.npy", mlp(_t(x)).numpy())
    back = gather_state_dict(mlp.state_dict(), g, order=list(full))
    assert list(back) == list(full)
    for n, v in full.items():
        assert torch.equal(back[n], v), n


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_tiny(seed=1, **kw):
    import jax
    import jax.numpy as jnp

    from dimsum_tpu.models.dim import DiM as JaxDiM, DiMConfig as JaxCfg
    from tests.test_torch_convert import randomize

    model = JaxDiM(JaxCfg(**{**TINY, **kw}, scan_impl="xla"))
    z = jnp.zeros((1, 4, 8, 8))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), z, jnp.zeros((1,)),
                                 jnp.zeros((1,), jnp.int32))
    return model, jax.tree.map(jnp.asarray, randomize(params, seed))


def _save_full(path, params):
    from dimsum_torch.utils.convert import state_dict_from_jax_params

    sd = state_dict_from_jax_params(params)
    torch.save(sd, path / "full.pt")
    return sd


def _scaled(got, want, tol, name=""):
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


# ---------------------------------------------------------------------------
# state-dict sharding
# ---------------------------------------------------------------------------

def test_tp_rules_cut_each_part_alike():
    """in_proj's [x; z], w12's [a; b] and qkv's [q; k; v] are cut part by
    part: rank r holds the same channel range (heads) of each part; the
    JAX rule table's names map to the port's; the shards put back
    together are the full tensor."""
    full = torch.arange(24.0).reshape(8, 3)
    a, b = (shard_state_dict({"m.in_proj.weight": full}, r, 2)
            ["m.in_proj.weight"] for r in range(2))
    assert torch.equal(a, full[[0, 1, 4, 5]])
    assert torch.equal(b, full[[2, 3, 6, 7]])
    qkv = torch.arange(12.0)
    assert torch.equal(shard_state_dict({"a.qkv.bias": qkv}, 1, 2)
                       ["a.qkv.bias"], qkv[[2, 3, 6, 7, 10, 11]])
    for name, rule in (("b.mixer.x_proj.weight", (1, 1)),
                       ("b.mixer.x_proj_b.weight", (1, 1)),
                       ("b.mixer.out_proj.weight", (1, 1)),
                       ("b.mixer.conv1d.weight", (0, 1)),
                       ("b.mixer.conv1d_b.bias", (0, 1)),
                       ("b.mixer.dt_proj.bias", (0, 1)),
                       ("b.mixer.A_b_log", (0, 1)), ("b.mixer.D", (0, 1)),
                       ("b.mlp.w12.bias", (0, 2)), ("b.mlp.w3.weight", (1, 1)),
                       ("b.proj.qkv2.weight", (0, 3)),
                       ("b.mlp.w3.bias", None), ("b.proj.proj.weight", None),
                       ("b.mixer.cond_proj.weight", None),
                       ("b.adaLN_modulation.1.weight", None),
                       ("b.mixer.router.weight", None)):
        assert tp_rule(name) == rule, name
    assert is_sharded("b.mixer.local_experts.3.linear_fc1.weight")


@pytest.mark.parametrize("device, ranks, cards, local, want", [
    ("cpu", 2, 4, None, "gloo"),
    ("cuda", 2, 4, None, "nccl"),
    ("cuda", 4, 4, None, "nccl"),
    ("cuda", 2, 1, None, "gloo"),      # two ranks on one card
    ("cuda", 8, 4, "4", "nccl"),       # two hosts of four cards
    ("cuda", 8, 4, "8", "gloo"),
])
def test_default_backend_takes_gloo_where_ranks_share_a_card(
        monkeypatch, device, ranks, cards, local, want):
    """`init_distributed`'s one backend rule: NCCL when each of the host's
    ranks (LOCAL_WORLD_SIZE, else all) has a card, gloo on the CPU and
    where ranks share a card."""
    from dimsum_torch.parallel.mesh import default_backend

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    assert default_backend(device, ranks) == want


# ---------------------------------------------------------------------------
# TP: a train step, against JAX unsharded and under tp_shardings
# ---------------------------------------------------------------------------

def _jax_step(is_moe, draws):
    """The JAX step's loss and norm (`make_train_step`, unsharded, and for
    the dense DiM under `tp_shardings` on a model axis of 8, which JAX's
    own test holds to the unsharded step: tests/test_parallel.py:249-287),
    with its `sample` patched to the fixed draws, and `jax.value_and_grad`
    of the same loss."""
    import jax
    import jax.numpy as jnp

    from dimsum_tpu.parallel import (create_optimizer, create_train_state,
                                     make_mesh, make_train_step, tp_shardings)
    from dimsum_tpu.transport import create_transport
    from dimsum_tpu.transport.transport import Transport as JaxTransport

    model, params = _jax_tiny(is_moe=is_moe)
    params = params["params"]
    t, x0 = jnp.asarray(draws["t"]), jnp.asarray(draws["x0"])
    x, y = jnp.asarray(draws["x1"]), jnp.asarray(draws["y"])
    opt = create_optimizer(LR)
    tr = create_transport("GVP", "velocity")
    metrics = []
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(JaxTransport, "sample",
                       lambda self, rng, x1: (t, x0, x1))
        step = make_train_step(model, tr, opt, mesh=None,
                               max_grad_norm=CLIP, ema_decay=EMA)
        metrics.append(step(create_train_state(params, opt), x, y,
                            jax.random.PRNGKey(2))[1])
        if not is_moe:
            mesh = make_mesh(data=1, model=8)
            p_c = jax.device_put(params, tp_shardings(mesh, params))
            metrics.append(step(create_train_state(p_c, opt), x, y,
                                jax.random.PRNGKey(2))[1])

        def loss_fn(p):
            def model_fn(xt, t_, **kw):
                return model.apply({"params": p}, xt, t_, train=True, **kw)
            return tr.training_losses(model_fn, jax.random.PRNGKey(2), x,
                                      {"y": y})["loss"].mean()

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return params, metrics, float(loss), grads


def _jax_update(params, grads):
    """AdamW (the JAX `create_optimizer`) and the EMA of the JAX step on
    given (already clipped) gradients."""
    import jax
    import optax

    from dimsum_tpu.parallel.train import create_optimizer, ema_update

    @jax.jit
    def update(p, g):
        opt = create_optimizer(LR)
        upd, _ = opt.update(g, opt.init(p), p)
        new = optax.apply_updates(p, upd)
        return new, ema_update(p, new, EMA)

    return update(params, grads)


@pytest.mark.parametrize("is_moe", [False, True])
def test_tp_train_step_matches_jax(tmp_path, is_moe):
    """One train step of the tiny DiM over a model group of 2 ranks (with
    `is_moe`, the MoE DiM with its experts split over the ranks, capacity
    factor 8 so that no token is dropped) against JAX: the loss and the
    global norm against the JAX `make_train_step` unsharded and (the dense
    DiM) under `tp_shardings` (loss rtol 1e-5, norm 1e-4); every gradient,
    gathered
    back to the full names, against `jax.value_and_grad` scaled by the
    clip (1e-3 of each tensor's scale, `tests/test_torch_train.py`'s
    tolerance); and every updated parameter and EMA entry against the JAX
    AdamW and EMA applied to those gradients (atol 5e-6 / rtol 1e-4, the
    JAX package's TP tolerance: the step's arithmetic on the shards).  Held
    through the gradients, not the updated parameters alone, because
    Adam's first step divides by |g| + eps: an entry whose gradient is
    within ~100 eps of 0 moves by noise in either package.  The replicated
    parameters' gradients are equal across the group."""
    from dimsum_torch.utils.convert import state_dict_from_jax_params

    rng = np.random.default_rng(3)
    draws = dict(x1=rng.standard_normal((N, 4, 8, 8)).astype(np.float32),
                 x0=rng.standard_normal((N, 4, 8, 8)).astype(np.float32),
                 t=rng.uniform(0.05, 0.95, N).astype(np.float32),
                 y=(np.arange(N) % 10).astype(np.int32))
    params, metrics, jloss, jgrads = _jax_step(is_moe, draws)
    full = _save_full(tmp_path, {"params": params})
    np.savez(tmp_path / "draws.npz", **draws)
    _spawn(_train_rank, tmp_path, tmp_path, is_moe)

    loss, norm = np.load(tmp_path / "metrics.npy")
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for m in metrics:
        np.testing.assert_allclose(loss, float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(norm, float(m["grad_norm"]), rtol=1e-4)
    scale = min(1.0, CLIP / float(metrics[0]["grad_norm"]))
    assert scale < 1.0  # the clip acts
    got_g = dict(np.load(tmp_path / "grads.npz"))
    want_g = state_dict_from_jax_params({"params": jgrads})
    assert set(got_g) == set(full) == set(want_g)
    for name, w in want_g.items():
        _scaled(got_g[name], scale * w.numpy(), 1e-3, name)
    from dimsum_tpu.utils.ckpt import convert_torch_state_dict

    new, ema = _jax_update(params, convert_torch_state_dict(
        got_g, params, strict=True))
    want_p = state_dict_from_jax_params({"params": new})
    want_e = state_dict_from_jax_params({"params": ema})
    got_p = dict(np.load(tmp_path / "params.npz"))
    got_e = dict(np.load(tmp_path / "ema.npz"))
    for name in full:
        np.testing.assert_allclose(got_p[name], want_p[name].numpy(),
                                   atol=5e-6, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(got_e[name], want_e[name].numpy(),
                                   atol=5e-6, rtol=1e-4, err_msg=name)
    g0, g1 = (dict(np.load(tmp_path / f"grads{r}.npz")) for r in range(K))
    assert set(g0) == set(g1) and len(g0) > 10
    for name in g0:
        np.testing.assert_array_equal(g0[name], g1[name], err_msg=name)


# ---------------------------------------------------------------------------
# TP: the sampling forward
# ---------------------------------------------------------------------------

def _forward_inputs(path):
    rng = np.random.default_rng(5)
    inp = dict(x=rng.standard_normal((3, 4, 8, 8)).astype(np.float32),
               t=rng.uniform(0.1, 0.9, 3).astype(np.float32),
               y=np.array([1, 7, 10], np.int32))
    np.savez(path / "inputs.npz", **inp)
    return inp


# the TP forward's configurations: plain, and the fused switches
FORWARD_SWITCHES = ({}, dict(pallas_norm=True, fused_norm=True,
                             conv_xproj=True, pending_tail=2))
# a tiny DiT with its gated MLP (use_gated_mlp is a DiT block field; the
# DiT model takes timm's Mlp, whole under TP): 8 heads of Dh 4
DIT_CFG = dict(img_resolution=8, patch_size=2, hidden_size=32, depth=2,
               num_heads=8, num_classes=10)


def test_tp_forward_matches_jax(tmp_path):
    """The tiny DiM's forward over 2 ranks against the JAX forward, and,
    with the fused switches on (the kernels' plain versions on the CPU;
    the conv + x_proj product's partial x_dbl summed over the group), the
    same on both ranks and 1e-5 of scale from the unsharded port with the
    switches.  A tiny DiT (its heads split over the ranks) against the
    JAX DiT too."""
    import jax
    import jax.numpy as jnp

    from dimsum_tpu.models.dit import DiT as JaxDiT, DiTConfig as JaxDiTCfg
    from dimsum_torch.utils.convert import state_dict_from_jax_params
    from tests.test_torch_convert import randomize

    model, params = _jax_tiny(label_dropout=0.1)
    inp = _forward_inputs(tmp_path)
    tiny = dict(TINY, label_dropout=0.1)
    full = _save_full(tmp_path, params)
    jdit = JaxDiT(JaxDiTCfg(**DIT_CFG))
    dparams = jax.tree.map(jnp.asarray, randomize(jax.jit(jdit.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,)),
        jnp.zeros((1,), jnp.int32)), 4))
    torch.save(state_dict_from_jax_params(dparams), tmp_path / "dit.pt")
    want_dit = np.asarray(jdit.apply(dparams, *(jnp.asarray(inp[n]) for n
                                                 in ("x", "t", "y"))))
    want = np.asarray(model.apply(params, jnp.asarray(inp["x"]),
                                  jnp.asarray(inp["t"]),
                                  jnp.asarray(inp["y"])))
    _spawn(_forward_rank, tmp_path, tmp_path)
    for i, switches in enumerate(FORWARD_SWITCHES):
        outs = [np.load(tmp_path / f"out{r}_{i}.npy") for r in range(K)]
        np.testing.assert_array_equal(outs[0], outs[1])
        if not switches:
            _scaled(outs[0], want, 1e-5, "tp forward")
            dits = [np.load(tmp_path / f"dit{r}.npy") for r in range(K)]
            np.testing.assert_array_equal(dits[0], dits[1])
            _scaled(dits[0], want_dit, 1e-5, "tp DiT forward")
            continue
        ref = DiM(DiMConfig(**tiny, **switches))
        ref.load_state_dict(full, strict=True)
        with torch.no_grad():
            local = ref.eval()(_t(inp["x"]), _t(inp["t"]),
                               _t(inp["y"]).long()).numpy()
        _scaled(outs[0], local, 1e-5, "tp fused forward")


# ---------------------------------------------------------------------------
# EP: switch_ep over 2 ranks against switch_ep_gspmd (mesh=None)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_ep_matches_jax_switch_ep_gspmd(tmp_path, cf):
    """The SwitchMLP's expert-parallel route over 2 ranks (4 experts each)
    against the JAX `switch_ep_gspmd` unsharded on the JAX
    `stack_expert_params` of the same dense weights: at capacity factor
    0.5 tokens are dropped (and the test checks that some are), at 8 none
    are, and both routes then equal the dense SwitchMLP.  The port's
    `stack_expert_params` equals JAX's."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from dimsum_tpu.models.blocks import SwitchMLP as JaxSwitch
    from dimsum_tpu.parallel.moe_ep import (stack_expert_params,
                                            switch_ep_gspmd)
    from dimsum_torch.parallel.moe_ep import capacity, dispatch_top1
    from dimsum_torch.parallel.moe_ep import \
        stack_expert_params as port_stack
    from dimsum_torch.utils.convert import state_dict_from_jax_params
    from tests.test_torch_convert import randomize

    D, E = 32, 8
    x = np.random.default_rng(7).standard_normal((2, 16, D)).astype(
        np.float32)
    dense = JaxSwitch(dim=D, num_moe_experts=E)
    p = randomize(jax.eval_shape(dense.init, jax.random.PRNGKey(0),
                                 jnp.asarray(x)), 3)["params"]
    p = jax.tree.map(jnp.asarray, p)
    stacked = stack_expert_params(p)
    logits = nn.Dense(E).apply({"params": p["router"]}, jnp.asarray(x))
    want = np.asarray(switch_ep_gspmd(jnp.asarray(x), logits, stacked["w1"],
                                      stacked["w2"], mesh=None,
                                      capacity_factor=cf))
    full = {k[len("mixer."):]: v for k, v in state_dict_from_jax_params(
        {"params": {"mixer": p}}).items()}
    torch.save(full, tmp_path / "switch.pt")
    np.save(tmp_path / "x.npy", x)
    ours = port_stack(full)
    np.testing.assert_array_equal(ours["w1"].numpy(),
                                  np.asarray(stacked["w1"]))
    np.testing.assert_array_equal(ours["w2"].numpy(),
                                  np.asarray(stacked["w2"]))
    _spawn(_ep_rank, tmp_path, tmp_path, cf)
    outs = [np.load(tmp_path / f"out{r}.npy") for r in range(K)]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0], want, atol=1e-5, rtol=1e-5)
    _, _, keep = dispatch_top1(_t(np.asarray(logits)).reshape(-1, E),
                               capacity(32, E, cf))
    dense_out = np.asarray(dense.apply({"params": p}, jnp.asarray(x)))
    if cf < 1:
        assert not keep.all()
        dropped = ~keep.numpy().reshape(2, 16)
        assert (np.abs(outs[0][dropped]) == 0).all()
        assert not np.allclose(outs[0], dense_out, atol=1e-4)
    else:
        assert keep.all()
        np.testing.assert_allclose(outs[0], dense_out, atol=1e-5, rtol=1e-5)
