"""The plain reference against the port's plain routes in float32 on the
CPU, at a narrow width of each configuration, from the same weights: the
two are independent codes of the same mathematics."""

import pytest
import torch

from perfbench import reference
from perfbench.entries import port
from perfbench.reference import sampling
from perfbench.reference.model import selective_scan
from perfbench.tests.test_perfbench_faults import narrow
from perfbench.weights import make_weights


def test_recurrence_gradients():
    g = torch.Generator().manual_seed(0)
    b, L, d, n = 2, 9, 4, 3

    def r(*s):
        return torch.randn(*s, generator=g, dtype=torch.float64)

    args = [r(b, L, d), torch.rand(b, L, d, generator=g,
                                   dtype=torch.float64) * 0.5,
            -torch.rand(d, n, generator=g, dtype=torch.float64) - 0.1,
            r(b, L, n), r(b, L, n), r(d), r(b, L, d)]
    args = [a.requires_grad_() for a in args]
    assert torch.autograd.gradcheck(selective_scan, args)


@pytest.mark.parametrize("name", ["dim-l2.sample-256", "dit-xl2.sample-512",
                                  "dim-l2.sample-512"])
def test_reference_equals_the_ports_plain_routes(name):
    cell = narrow(name)
    if name.endswith("512"):
        cell["model"]["img_resolution"] = 64   # L 1024: the 512-px routes
    cfg = dict(cell["model"], compute_dtype="float32")
    ref = reference.model.build(cfg)
    w = make_weights(ref, 2 ** 31 + 77, "cpu")
    net = port.build(cfg, w, "cpu")
    ref.load_state_dict(w, assign=True)
    g = torch.Generator().manual_seed(1)
    s = cfg["img_resolution"]
    x = torch.randn(4, 4, s, s, generator=g)
    t = torch.rand(4, generator=g)
    y = torch.tensor([1, 2, cfg["num_classes"], 3])
    with torch.no_grad():
        want = ref(x, t, y)
        got = net(x, t, y)
        cfg_want = sampling.cfg_forward(ref, torch.cat([x[:2], x[:2]]), t,
                                        y, 1.4, 4, 3)
    from dimsum_torch.models.dim import forward_with_cfg

    with torch.no_grad():
        cfg_got = forward_with_cfg(net, torch.cat([x[:2], x[:2]]), t, y,
                                   cfg_scale=1.4, in_channels=4)[:, :4]
    scale = want.abs().max()
    assert (got - want).abs().max() <= 2e-5 * scale
    assert (cfg_got - cfg_want).abs().max() <= 2e-5 * cfg_want.abs().max()
