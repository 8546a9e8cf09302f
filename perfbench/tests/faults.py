"""Faults planted in the port under the harness, each of a kind that
`correct` has to catch: a step that returns its state unchanged, half of
the batch left out (the mean taken over the rest), an answer altered
where it is produced (a drift call's first token negated; a training
step's prediction for the first token of each sample ten times too
large: with random weights the prediction is uncorrelated with its
target, so a sign alone barely moves the loss), and a training step's
EMA left out.  One card: no exchange between chips to leave out."""

import torch


def _negate_first_token(out):
    """The first 2 x 2 patch of every row, negated."""
    out = out.clone()
    out[:, :, :2, :2] = -out[:, :, :2, :2]
    return out


def plant(entry: str, fault: str, monkeypatch):
    if entry == "sample":
        _sample(fault, monkeypatch)
    else:
        _train(fault, monkeypatch)


def _sample(fault, monkeypatch):
    from dimsum_torch.models import dim
    from dimsum_torch.transport import integrators, transport

    if fault == "unchanged":
        def stuck(drift, x, t0, t1, num_steps):
            for t in integrators._grid(t0, t1, num_steps)[:-1].tolist():
                drift(x, integrators._tvec(x, t))
            return x
        monkeypatch.setattr(transport, "ode_euler", stuck)
        return
    cfg_fn = dim.forward_with_cfg

    if fault == "half":
        def half(model, x, t, y, cfg_scale=1.0, in_channels=4):
            n = x.shape[0] // 2
            keep = x.clone()
            keep[n // 2:n] = x[:n - n // 2]
            keep[n + n // 2:] = x[n:n + n - n // 2]
            return cfg_fn(model, keep, t, y, cfg_scale, in_channels)
        monkeypatch.setattr(dim, "forward_with_cfg", half)
    elif fault == "altered":
        def altered(*a, **k):
            return _negate_first_token(cfg_fn(*a, **k))
        monkeypatch.setattr(dim, "forward_with_cfg", altered)
    else:
        raise ValueError(fault)


def _train(fault, monkeypatch):
    from dimsum_torch.transport.transport import Transport

    losses = Transport.training_losses
    if fault == "unchanged":
        step = torch.optim.AdamW.step

        def kept(self, *a, **k):
            before = [p.detach().clone() for g in self.param_groups
                      for p in g["params"]]
            out = step(self, *a, **k)
            with torch.no_grad():
                for p, q in zip((p for g in self.param_groups
                                 for p in g["params"]), before):
                    p.copy_(q)
            return out
        monkeypatch.setattr(torch.optim.AdamW, "step", kept)
    elif fault == "half":
        def half(self, model_fn, x1, generator=None, model_kwargs=None):
            out = losses(self, model_fn, x1, generator, model_kwargs)
            out["loss"] = out["loss"][: x1.shape[0] // 2]
            return out
        monkeypatch.setattr(Transport, "training_losses", half)
    elif fault == "altered":
        def altered(self, model_fn, x1, generator=None, model_kwargs=None):
            def fn(xt, t, **kw):
                out = model_fn(xt, t, **kw).clone()
                out[:, :, :2, :2] *= 10.0   # a wrong value in a token
                return out
            return losses(self, fn, x1, generator, model_kwargs)
        monkeypatch.setattr(Transport, "training_losses", altered)
    elif fault == "ema":
        from dimsum_torch.parallel import train

        monkeypatch.setattr(train, "ema_update", lambda *a, **k: None)
    else:
        raise ValueError(fault)
