"""Training held to the JAX package over 20 steps, not one: the tiny DiM
(hidden 32, depth 2, a DiT block after the 2nd, latent 8) from the same
weights, fed by each package's own `Loader` from one latent memmap (48
samples, batch 4, the epochs reshuffled), each stepping with its own
`make_train_step` (AdamW at lr 1e-4, clip 1.0, EMA 0.9) in fp32, with the
draws injected (t and x0 a fixed function of the batch, the label-drop ids
of the labels; no stochastic depth, whose masks here would hang on values
the two packages round differently).  After every 5 steps the port's
weights and EMA are held to JAX's.

Tolerance.  The JAX CPU route scans associatively and the port
sequentially (~1e-6 relative apart a step, tests/test_torch_train.py).
AdamW turns that into a weight difference of up to lr a step where a
gradient is rounding noise (below 1e-3 of its tensor's largest in a step
so far; the attention key biases, whose true gradient is 0), and hardly
moves the rest.  Measured at steps 5, 10, 15, 20: the other entries'
weights within 2.4e-7 at every check, their EMA within 9.5e-7, 1.4e-6,
1.4e-6, 1.4e-6; the noise entries' weights within 2.3e-5, 4.1e-5, 3.7e-5,
5.0e-5 (0.5 lr at step 20) and their EMA within 6.7e-6 ... 3.3e-5.  Held
to: the other entries 1e-6 (weights) and 5e-6 (EMA), 4x and 3.5x the
drift; the noise entries 0.1 lr per step taken (5e-5 at step 5, 2e-4 at
step 20), 2.2x to 4x.
"""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from dimsum_tpu.data import LatentMemmapDataset as JaxMemmap
from dimsum_tpu.data import Loader as JaxLoader
from dimsum_tpu.models.dim import DiM as JaxDiM
from dimsum_tpu.models.dim import DiMConfig as JaxDiMConfig
from dimsum_tpu.parallel.train import create_optimizer as jax_optimizer
from dimsum_tpu.parallel.train import create_train_state as jax_state
from dimsum_tpu.parallel.train import make_train_step as jax_make_step
from dimsum_tpu.transport import create_transport as jax_transport
from dimsum_tpu.transport.transport import Transport as JaxTransport
from dimsum_torch.data import LatentMemmapDataset, Loader, device_batches
from dimsum_torch.models.dim import DiM, DiMConfig
from dimsum_torch.parallel import (create_optimizer, create_train_state,
                                   make_train_step)
from dimsum_torch.utils.convert import state_dict_from_jax_params
from tests.test_torch_convert import (PUBLISHED, randomize,  # noqa: F401
                                     torch_one_thread)
from tests.test_torch_train_cli import data_keyed_transport

TINY = dict(img_resolution=8, hidden_size=32, depth=2, num_classes=10,
            use_attn_every_k_layers=2, label_dropout=0.1)
N, BATCH, STEPS, LR, EMA = 48, 4, 20, 1e-4, 0.9


class _LabelKeyedDrops:
    """The JAX model with the label-drop ids of the port's injected
    transport, (y % 3 == 0)."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, xt, t, y=None, **kw):
        return self.model.apply(variables, xt, t, y=y,
                                force_drop_ids=(y % 3 == 0).astype(jnp.int32),
                                **kw)


def _jax_sample(self, rng, x1):
    t = jnp.clip(jnp.abs(x1[:, 0, 0, 0]) * 0.3, 0.05, 0.95)
    return t, x1[:, ::-1] * 0.5, x1


def _batches(loader):
    epoch = 0
    while True:
        loader.set_epoch(epoch)
        yield from loader
        epoch += 1


def test_twenty_steps_track_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    rng.standard_normal((N, 4, 8, 8)).astype(np.float32).tofile(
        tmp_path / "latents.dat")
    rng.integers(0, 10, N).astype(np.int64).tofile(tmp_path / "labels.dat")
    files = (str(tmp_path / "latents.dat"), str(tmp_path / "labels.dat"))

    jmodel = JaxDiM(JaxDiMConfig(**TINY, **PUBLISHED))
    params = randomize(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 4, 8, 8)), jnp.zeros((2,)),
        jnp.zeros((2,), jnp.int32)), 0)["params"]
    monkeypatch.setattr(JaxTransport, "sample", _jax_sample)
    opt = jax_optimizer(LR)
    jstep = jax_make_step(_LabelKeyedDrops(jmodel),
                          jax_transport("GVP", "velocity"), opt,
                          max_grad_norm=1.0, ema_decay=EMA)
    jstate = jax_state(params, opt)
    jbatches = _batches(JaxLoader(JaxMemmap(*files, latent_shape=(4, 8, 8)),
                                  BATCH, seed=1))

    port = DiM(DiMConfig(**TINY))
    port.load_state_dict(state_dict_from_jax_params(params), strict=True)
    popt = create_optimizer(port.train(), lr=LR)
    state = create_train_state(port, popt)
    step = make_train_step(port, data_keyed_transport(), popt,
                           max_grad_norm=1.0, ema_decay=EMA)
    loader = Loader(LatentMemmapDataset(*files, latent_shape=(4, 8, 8)),
                    BATCH, seed=1)
    batches = (b for batch in _batches(loader)
               for b in device_batches([batch], "cpu"))

    drift = []
    noise = {n: torch.zeros(p.shape, dtype=torch.bool)
             for n, p in port.named_parameters()}
    for i in range(1, STEPS + 1):
        jx, jy = next(jbatches)
        jstate, jm = jstep(jstate, jx, jy, jax.random.PRNGKey(i))
        x, y = next(batches)
        np.testing.assert_array_equal(x.numpy(), jx)
        m = step(state, x, y, None)
        for n, p in port.named_parameters():
            g = p.grad.abs()
            noise[n] |= g <= 1e-3 * g.max().clamp_min(1e-30)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=1e-4)
        if i % 5:
            continue
        want_p = state_dict_from_jax_params(jstate.params)
        want_e = state_dict_from_jax_params(jstate.ema_params)
        # weights, their noise entries, EMA, its noise entries
        worst = np.zeros(4)
        for name, p in port.named_parameters():
            d = (p.detach() - want_p[name]).abs()
            e = (state.ema_params[name] - want_e[name]).abs()
            nm = noise[name]
            for j, v in enumerate((d[~nm], d[nm], e[~nm], e[nm])):
                if v.numel():
                    worst[j] = max(worst[j], v.max().item())
        drift.append((i, *worst.tolist()))
        assert worst[0] <= 1e-6 and worst[2] <= 5e-6, drift
        assert worst[1] <= 0.1 * LR * i and worst[3] <= 0.1 * LR * i, drift
