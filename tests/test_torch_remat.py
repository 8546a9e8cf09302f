"""The port's remat (`DiMConfig.grad_checkpoint` and `remat_policy`,
`dimsum_torch/utils/remat.py`) against its own model without remat and
against the JAX package's remat, on the tiny DiM of tests/test_remat.py
(hidden 32, depth 2, a DiT block after the 2nd, latent 8) with the JAX
weights carried across, over that test's grid of policies.

  * every policy: the loss and every gradient of sum(out ** 2) equal the
    port's without remat bit for bit (tolerance 0: the replay runs the
    same ops in the same order, and a kept output is the first forward's
    own), and match the JAX model's with the same policy at
    tests/test_remat.py's tolerance: the loss to rtol 1e-6 (measured
    2.1e-7), each gradient to atol 1e-5 plus rtol 1e-4 of the tensor's
    largest value (measured 4.2e-6 of it at most; entry by entry the two
    differ by more, 2.7e-4 relative at an entry 3% of its tensor's scale,
    because the JAX route scans associatively and the port sequentially,
    with or without remat).  The four "save:" policies are in
    tests/test_torch_remat_save.py (each JAX policy is a compile of ~6 s);
  * stochastic depth (drop path 0.3, train mode, one seeded generator):
    bit for bit with and without remat, the generator left where a run
    without remat leaves it; a replay that draws new masks (the generator
    not set back) gives other gradients, so the check catches it;
  * pending_tail 2 under remat equals pending_tail 0 bit for bit (the
    tail is off under remat, as in JAX);
  * the kernel sites' kept outputs: conv + x_proj (its Function, on the
    CPU through its plain version) and the scan's training Function run
    their forward once a call under a policy that keeps them and twice
    under full remat, with equal gradients;
  * what each policy keeps on the dispatcher's side is held in
    tests/test_torch_remat_ops.py;
  * unknown policies and tags raise as the JAX ones do.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import dimsum_torch.ops.conv_xproj as port_convx
import dimsum_torch.ops.selective_scan as port_scan
from dimsum_tpu.models.dim import DiM as JaxDiM
from dimsum_tpu.models.dim import DiMConfig as JaxDiMConfig
from dimsum_torch.models.dim import DiM, DiMConfig, random_init_
from dimsum_torch.utils import remat
from dimsum_torch.utils.convert import state_dict_from_jax_params
from tests.test_torch_convert import (PUBLISHED, randomize,  # noqa: F401
                                     torch_one_thread)

CFG = dict(img_resolution=8, hidden_size=32, depth=2, num_classes=10,
           use_attn_every_k_layers=2, label_dropout=0.1)
POLICIES = [None, "dots", "scan", "dots_scan"]
SAVE_POLICIES = ["save:dots+scan_out+attn_out",
                 "save:scan_out+attn_out+conv_out", "save:attn_out",
                 "save:conv_out"]


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.linspace(0.2, 0.8, 2).astype(np.float32)
    y = np.arange(2, dtype=np.int32)
    return x, t, y


def _port_loss_and_grads(params, **cfg):
    x, t, y = _inputs()
    port = DiM(DiMConfig(**CFG, **cfg))
    port.load_state_dict(state_dict_from_jax_params(params), strict=True)
    loss = (port(torch.from_numpy(x), torch.from_numpy(t),
                 torch.from_numpy(y).long()) ** 2).sum()
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in port.named_parameters()
                           if p.grad is not None}


@pytest.fixture(scope="module")
def reference():
    """The JAX params (randomized so that no branch is zero) and the
    port's loss and gradients without remat."""
    x, t, y = _inputs()
    jmodel = JaxDiM(JaxDiMConfig(**CFG, **PUBLISHED, scan_impl="xla"))
    params = randomize(jax.jit(jmodel.init)(
        jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(t),
        jnp.asarray(y)), 0)
    loss, grads = _port_loss_and_grads(params)
    return dict(params=params, loss=loss, grads=grads)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_equals_no_remat_and_jax(policy, reference):
    check_policy(policy, reference)


def check_policy(policy, reference):
    """The port with remat under `policy` against itself without and
    against the JAX model with it."""
    loss, grads = _port_loss_and_grads(reference["params"],
                                       grad_checkpoint=True,
                                       remat_policy=policy)
    assert torch.equal(loss, reference["loss"])
    assert set(grads) == set(reference["grads"])
    for name, g in grads.items():
        assert torch.equal(g, reference["grads"][name]), name

    x, t, y = _inputs()
    jmodel = JaxDiM(JaxDiMConfig(**CFG, **PUBLISHED, scan_impl="xla",
                                 grad_checkpoint=True, remat_policy=policy))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum(jmodel.apply({"params": p}, x, t, y) ** 2)))(
        reference["params"]["params"])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    want = state_dict_from_jax_params(jgrads)
    for name, g in grads.items():
        w = want[name].numpy()
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-5 + 1e-4 * np.abs(w).max(), (name, err)


def _drop_path_step(generator_seed=5, **cfg):
    """sum(out ** 2) of the port DiM at depth 4 in train mode (drop path
    0.3: blocks 2 and 3 drop at 0.1 and 0.2; label dropout 0.1) with every
    draw from one generator; returns the loss, the gradients and the
    generator's state after the backward."""
    model = random_init_(DiM(DiMConfig(**dict(CFG, depth=4), drop_path=0.3,
                                       **cfg)), 0)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 4, 8, 8)).astype(
        np.float32))
    g = torch.Generator().manual_seed(generator_seed)
    out = model.train()(x, torch.tensor([0.1, 0.4, 0.6, 0.9]),
                        torch.tensor([1, 2, 3, 4]), train=True, generator=g)
    loss = (out ** 2).sum()
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()
                           if p.grad is not None}, g.get_state()


@pytest.mark.parametrize("policy", [None, "scan"])
def test_drop_path_masks_replay_as_drawn(policy, monkeypatch):
    loss0, grads0, state0 = _drop_path_step()
    loss1, grads1, state1 = _drop_path_step(grad_checkpoint=True,
                                            remat_policy=policy)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(grads1[n], g) for n, g in grads0.items())
    assert torch.equal(state0, state1)
    # a faulty replay, drawing new masks from the advanced generator: the
    # forward (and loss) is the same, the gradients are not
    monkeypatch.setattr(remat, "replay_rng",
                        lambda generator, state: contextlib.nullcontext())
    loss2, grads2, _ = _drop_path_step(grad_checkpoint=True,
                                       remat_policy=policy)
    assert torch.equal(loss0, loss2)
    assert not all(torch.equal(grads2[n], g) for n, g in grads0.items())


def test_pending_tail_is_off_under_remat(reference):
    base = _port_loss_and_grads(reference["params"], grad_checkpoint=True)
    deferred = _port_loss_and_grads(reference["params"], grad_checkpoint=True,
                                    pending_tail=2)
    assert torch.equal(base[0], deferred[0])
    assert all(torch.equal(deferred[1][n], g) for n, g in base[1].items())
    model = DiM(DiMConfig(**CFG, grad_checkpoint=True, pending_tail=2))
    assert model.pending_tail == 0
    assert all(b.pending_tail == 0 for b in model.blocks)


def _count_forward_calls(monkeypatch, module, name):
    """Count the calls of module.name made with grad off (a Function's
    forward), not those of its backward's recompute."""
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kw):
        if not torch.is_grad_enabled():
            calls.append(1)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("policy,launches", [(None, 8), ("save:conv_out", 4),
                                             ("scan", 8)])
def test_conv_xproj_launches_per_policy(policy, launches, monkeypatch):
    """4 mixers (at hidden 128, the gate's narrowest width), each one
    conv + x_proj forward, replayed under remat unless conv_out is kept;
    the gradients equal those without remat."""
    cfg = dict(CFG, hidden_size=128, conv_xproj=True)
    model = random_init_(DiM(DiMConfig(**cfg)), 0)
    ref = _grads_of(model)
    calls = _count_forward_calls(monkeypatch, port_convx, "conv_xproj_ref")
    model = random_init_(DiM(DiMConfig(**cfg, grad_checkpoint=True,
                                       remat_policy=policy)), 0)
    got = _grads_of(model)
    assert len(calls) == launches
    assert all(torch.equal(got[n], g) for n, g in ref.items())


def _grads_of(model):
    x, t, y = _inputs()
    (model(torch.from_numpy(x), torch.from_numpy(t),
           torch.from_numpy(y).long()) ** 2).sum().backward()
    return {n: p.grad for n, p in model.named_parameters()
            if p.grad is not None}


@pytest.mark.parametrize("keep,launches", [(frozenset(), 2),
                                           (frozenset({"scan_out"}), 1)])
def test_scan_function_keeps_its_outputs(keep, launches, monkeypatch):
    """The scan's training Function (kernels 2 and 3 on the card, their
    plain versions here) under `remat.checkpoint`: one forward a call when
    scan_out is kept, two under full remat, the gradients as without."""
    rng = np.random.default_rng(2)
    b, L, d, n, r = 2, 40, 8, 4, 3

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32))

    u, dt_low = t(b, L, d).requires_grad_(), t(b, L, r).requires_grad_()
    dt_w, A = t(r, d, scale=0.3), -t(d, n).abs()
    B, C, D, z, bias = t(b, L, n), t(b, L, n), t(d), t(b, L, d), t(d)

    def scan(u, dt_low, generator=None):
        return port_scan.selective_scan_dtlow_train(
            u, dt_low, dt_w, A, B, C, D, z, bias, True).square().sum()

    want = torch.autograd.grad(scan(u, dt_low), [u, dt_low])
    calls = _count_forward_calls(monkeypatch, port_scan,
                                 "selective_scan_fwd_train")
    got = torch.autograd.grad(remat.checkpoint(scan, keep, u, dt_low),
                              [u, dt_low])
    assert len(calls) == launches
    assert all(torch.equal(a, w) for a, w in zip(got, want))


def test_unknown_policies_raise():
    with pytest.raises(ValueError, match="unknown tags"):
        DiM(DiMConfig(**CFG, grad_checkpoint=True,
                      remat_policy="save:dots+bogus_tag"))
    with pytest.raises(ValueError, match="remat_policy"):
        DiM(DiMConfig(**CFG, grad_checkpoint=True, remat_policy="bogus"))
    assert remat.parse_policy("dots_scan") == {"dots", "scan_out"}
    assert remat.parse_policy("none") == frozenset()
    # as in JAX, the policy is read only under grad_checkpoint
    cfg = dataclasses.replace(DiMConfig(**CFG), remat_policy="bogus")
    assert DiM(cfg).remat_keep is None
