"""The port's sequence parallelism (SP) against the JAX package on the CPU:
the plain scan with h0 and the last state, the halo conv, the two-pass
scan, the Mamba mixer at mixer level, and a tiny L = 1024 DiM in island
mode.  The port's ranks are K spawned processes joined by gloo over a
`file://` store under the test's tmp_path (no TCP port: the suite's xdist
workers share the host), each with one PyTorch thread; on the CPU the
scan takes its plain version.  The JAX side runs unsharded in the test's
own process, on the same numpy inputs and the same weights (JAX `init`
refilled by `randomize`, carried over by `state_dict_from_jax_params`).

This module is imported by every spawned rank, so it imports neither JAX
nor the JAX package at its top: the tests import them inside.

Tolerances, fp32.  The JAX package's own SP tests hold the scan to rtol
2e-3 / atol 1e-3, the mixer to 2e-5 and the DiM to rtol 2e-3 / atol 2e-4
(tests/test_scan_sp.py); these are tighter.  The JAX reference scans with
an associative scan, the port sequentially (and across shards by the
two-level fold), ~1e-6 relative apart: the scan and the halo conv 1e-5,
the mixer 1e-5, the DiM 5e-5 (tests/test_torch_512.py's forward tolerance
on the same route at L 1024)."""

import datetime
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dimsum_torch.models.dim import DiM, DiMConfig
from dimsum_torch.models.mamba import Mamba
from dimsum_torch.ops.causal_conv1d import causal_conv1d_halo
from dimsum_torch.ops.selective_scan import selective_scan_ref
from dimsum_torch.ops.selective_scan_sp import selective_scan_seq_parallel
from dimsum_torch.parallel import make_seq_group

K = 4          # ranks
TIMEOUT = 120  # seconds for a group of ranks, start-up included
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
# the tiny DiM of tests/test_scan_sp.py::test_dim_seq_parallel_matches_
# unsharded_L1024 (latent 64, patch 2: L = 1024), published architecture
TINY_L1024 = dict(img_resolution=64, patch_size=2, in_channels=4,
                  hidden_size=32, depth=2, num_classes=10)
PUBLISHED = dict(rms_norm=True, block_type="combined", cond_mamba=True,
                 learnable_pe=True)


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """One PyTorch intra-op thread, as `tests/test_torch_convert.py::
    torch_one_thread` sets for the other port modules (that module imports
    JAX, which the ranks must not)."""
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
        with torch.no_grad():
            fn(r, k, *args)
    finally:
        dist.destroy_process_group()


def _spawn(fn, tmp_path, *args, k=K):
    """fn(rank, k, *args) in k spawned ranks; raises if one fails or the
    group outlives TIMEOUT (then every rank is terminated)."""
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


def _shard(a, r, k, axis=1):
    s = a.shape[axis] // k
    return np.take(a, np.arange(r * s, (r + 1) * s), axis=axis)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _halo_rank(r, k, path):
    x = np.load(path / "x.npy")
    w, b = np.load(path / "w.npy"), np.load(path / "b.npy")
    group = make_seq_group(1, k).seq
    y = causal_conv1d_halo(_t(_shard(x, r, k)), _t(w), _t(b), "silu",
                           group=group)
    np.save(path / f"out{r}.npy", y.numpy())


SCAN_KEYS = ("u", "delta", "A", "B", "C", "D", "z", "bias")


def _scan_rank(r, k, path, data):
    """Rank r = d * seq + s of a (data, seq) split scans batch row d's
    L-shard s."""
    x = dict(np.load(path / "scan.npz"))
    groups = make_seq_group(data, k // data)
    assert dist.get_process_group_ranks(groups.seq) == \
        list(range(r - r % (k // data), r - r % (k // data) + k // data))
    assert dist.get_process_group_ranks(groups.data) == \
        list(range(r % (k // data), k, k // data))
    d, s = divmod(r, k // data)
    rows = slice(d * (x["u"].shape[0] // data),
                 (d + 1) * (x["u"].shape[0] // data))
    t = {n: (_t(_shard(v[rows], s, k // data))
             if n in ("u", "delta", "B", "C", "z") else _t(v))
         for n, v in x.items()}
    y = selective_scan_seq_parallel(*[t[n] for n in SCAN_KEYS[:6]],
                                    z=t["z"], delta_bias=t["bias"],
                                    delta_softplus=True, group=groups.seq)
    np.save(path / f"out{r}.npy", y.numpy())


def _mixer_rank(r, k, path):
    x = np.load(path / "x.npy")
    mixer = Mamba(x.shape[-1], d_state=8, seq_group=make_seq_group(1, k).seq)
    mixer.load_state_dict(torch.load(path / "mixer.pt"), strict=True)
    np.save(path / f"out{r}.npy",
            mixer.eval()(_t(_shard(x, r, k))).numpy())


def _dim_rank(r, k, path):
    inp = dict(np.load(path / "inputs.npz"))
    model = DiM(DiMConfig(**TINY_L1024, use_attn_every_k_layers=-1,
                          seq_group=make_seq_group(1, k).seq))
    model.load_state_dict(torch.load(path / "dim.pt"), strict=True)
    gathers = []
    real = dist.all_gather

    def counted(parts, x, group=None):
        gathers.append(tuple(x.shape))
        return real(parts, x, group=group)

    dist.all_gather = counted  # this rank's process only
    out = model.eval()(_t(inp["x"]), _t(inp["t"]), _t(inp["y"]).long())
    np.save(path / f"out{r}.npy", out.numpy())
    np.save(path / f"gathers{r}.npy", np.asarray(len(gathers)))


def _outputs(path, k=K):
    return [np.load(path / f"out{r}.npy") for r in range(k)]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def scan_inputs(rng, batch=2, L=64, dim=16, n=8):
    """tests/test_scan_sp.py::make_inputs."""
    u = rng.standard_normal((batch, L, dim)).astype(np.float32)
    delta = (0.5 * rng.standard_normal((batch, L, dim))).astype(np.float32)
    A = -np.exp(rng.standard_normal((dim, n)).astype(np.float32) * 0.5)
    B = rng.standard_normal((batch, L, n)).astype(np.float32)
    C = rng.standard_normal((batch, L, n)).astype(np.float32)
    D = np.ones(dim, np.float32)
    z = rng.standard_normal((batch, L, dim)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(dim)).astype(np.float32)
    return dict(zip(SCAN_KEYS, (u, delta, A, B, C, D, z, bias)))


# ---------------------------------------------------------------------------
# (a) the plain scan with h0 and the last state
# ---------------------------------------------------------------------------

def test_sp_ref_h0_and_last_state_match_jax():
    """selective_scan_ref seeded from h0, with its last state, against the
    JAX selective_scan_xla and the Pallas kernel in interpret mode (the
    shapes of tests/test_scan_sp.py's interpret test)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from dimsum_tpu.ops.selective_scan import (
        _selective_scan_pallas_fwd_impl, selective_scan_xla)

    rng = np.random.default_rng(2)
    x = scan_inputs(rng, L=64, dim=128, n=8)
    h0 = rng.standard_normal((2, 128, 8)).astype(np.float32)
    args = [x[n] for n in SCAN_KEYS]
    want, want_last = selective_scan_xla(*args, True, return_last_state=True,
                                         h0=jnp.asarray(h0))
    with pltpu.force_tpu_interpret_mode():
        kern, kern_last = _selective_scan_pallas_fwd_impl(
            *args, True, h0=jnp.asarray(h0), want_last_state=True)
    got, got_last = selective_scan_ref(*map(_t, args), True,
                                       return_last_state=True, h0=_t(h0))
    assert got_last.shape == (2, 128, 8)
    for ref, ref_last in ((want, want_last), (kern, kern_last)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **SCAN_TOL)
        np.testing.assert_allclose(got_last.numpy(), np.asarray(ref_last),
                                   **SCAN_TOL)


# ---------------------------------------------------------------------------
# (b) the halo conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [2, 4])
def test_sp_halo_conv_matches_jax(tmp_path, width):
    """causal_conv1d_halo over K ranks, the shards concatenated, against
    the JAX causal_conv1d of the whole sequence."""
    from dimsum_tpu.ops.causal_conv1d import causal_conv1d as jax_conv

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 16)).astype(np.float32)
    w = rng.standard_normal((16, width)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    for name, a in (("x", x), ("w", w), ("b", b)):
        np.save(tmp_path / f"{name}.npy", a)
    _spawn(_halo_rank, tmp_path, tmp_path)
    want = np.asarray(jax_conv(x, w, b, activation="silu"))
    np.testing.assert_allclose(np.concatenate(_outputs(tmp_path), axis=1),
                               want, **SCAN_TOL)


def test_sp_halo_conv_refuses_short_shards():
    """A shard shorter than W - 1 tokens raises, as in JAX, before any
    collective."""
    with pytest.raises(ValueError, match="shorter than the conv halo"):
        causal_conv1d_halo(torch.zeros(1, 2, 4), torch.zeros(4, 4))


# ---------------------------------------------------------------------------
# (c) the two-pass scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data", [1, 2])
def test_sp_scan_matches_jax(tmp_path, data):
    """selective_scan_seq_parallel over the seq groups of a (data, K /
    data) split (batch rows over data) against the JAX selective_scan_xla
    of the whole sequence (which JAX holds its own SP scan to)."""
    from dimsum_tpu.ops.selective_scan import selective_scan_xla

    x = scan_inputs(np.random.default_rng(1), L=128, dim=16, n=8)
    np.savez(tmp_path / "scan.npz", **x)
    _spawn(_scan_rank, tmp_path, tmp_path, data)
    want = np.asarray(selective_scan_xla(*[x[n] for n in SCAN_KEYS], True))
    seq = K // data
    outs = _outputs(tmp_path)
    got = np.concatenate([np.concatenate(outs[d * seq:(d + 1) * seq], axis=1)
                          for d in range(data)], axis=0)
    np.testing.assert_allclose(got, want, **SCAN_TOL)


# ---------------------------------------------------------------------------
# (d) the mixer at mixer level
# ---------------------------------------------------------------------------

def test_sp_mixer_matches_jax(tmp_path):
    """Mamba with seq_group, each rank given its L-shard (the JAX mixer
    inside shard_map), against the unsharded JAX Mamba with the same
    weights (tests/test_scan_sp.py's mixer: d_model 32, d_state 8)."""
    import jax
    import jax.numpy as jnp

    from dimsum_tpu.models.mamba import Mamba as JaxMamba
    from dimsum_torch.utils.convert import state_dict_from_jax_params
    from tests.test_torch_convert import randomize

    x = np.random.default_rng(4).standard_normal((2, 64, 32)).astype(
        np.float32)
    jm = JaxMamba(d_model=32, d_state=8, layer_idx=0)
    params = randomize(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), 4)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    sd = state_dict_from_jax_params({"mixer": params["params"]})
    torch.save({k[len("mixer."):]: v for k, v in sd.items()},
               tmp_path / "mixer.pt")
    np.save(tmp_path / "x.npy", x)
    _spawn(_mixer_rank, tmp_path, tmp_path)
    np.testing.assert_allclose(np.concatenate(_outputs(tmp_path), axis=1),
                               want, rtol=1e-5, atol=1e-5)


def test_sp_mixer_refuses_gradients():
    """SP is forward only: a mixer whose parameters need a gradient raises
    under grad mode, before any collective."""
    mixer = Mamba(8, d_state=4, seq_group=object())
    with pytest.raises(NotImplementedError, match="forward only"):
        mixer(torch.zeros(1, 8, 8))


# ---------------------------------------------------------------------------
# (e) the tiny L = 1024 DiM in island mode
# ---------------------------------------------------------------------------

def test_sp_dim_island_matches_jax(tmp_path):
    """DiMConfig.seq_group over K = 4 ranks (every mixer's conv and scan in
    an island) against the unsharded JAX DiM: every rank returns the whole
    output, the same on each; 3 all_gathers a mixer (halos, summaries,
    output), 4 mixers."""
    import jax
    import jax.numpy as jnp

    from dimsum_tpu.models.dim import DiM as JaxDiM
    from dimsum_tpu.models.dim import DiMConfig as JaxDiMConfig
    from dimsum_torch.utils.convert import state_dict_from_jax_params
    from tests.test_torch_convert import randomize

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 64, 64)).astype(np.float32)
    t = np.array([0.3, 0.7], np.float32)
    y = np.array([1, 2], np.int32)
    jmodel = JaxDiM(JaxDiMConfig(**TINY_L1024, **PUBLISHED, scan_impl="xla"))
    params = randomize(jax.jit(jmodel.init)(jax.random.PRNGKey(1), x, t, y),
                       5)
    want = np.asarray(jax.jit(jmodel.apply)(params, x, t, y))
    torch.save(state_dict_from_jax_params(params), tmp_path / "dim.pt")
    np.savez(tmp_path / "inputs.npz", x=x, t=t, y=y)
    _spawn(_dim_rank, tmp_path, tmp_path)
    outs = _outputs(tmp_path)
    for r in range(K):
        np.testing.assert_array_equal(outs[r], outs[0])
        assert int(np.load(tmp_path / f"gathers{r}.npy")) == 3 * 4
    np.testing.assert_allclose(outs[0], want, rtol=5e-5, atol=5e-5)
