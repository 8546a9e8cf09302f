"""A run of the harness without its look for a card, at a narrow width on
the CPU (the port's kernels take their plain versions there), with the
timed path broken underneath: each fault has to turn `correct` false
under the cells' own limits, and lift one compared number to three times
the sound run's at the same width (the narrow training run's leaf gaps
are wider than the full width's, which the limits are set from)."""

import pytest

from perfbench.common import load_cell, model_fields
from perfbench.entries import sample, train
from perfbench.tests import faults

SEED = 2 ** 31 + 4242


def narrow(name):
    """The cell at a narrow width: DiM-S/2 (hidden 256, depth 4) or
    DiT-S/2 (hidden 384, 12 blocks of 6 heads), 128 px, few rows."""
    cell = load_cell(name)
    m = cell["config_file"]["model"]
    if m["family"] == "dim":
        m.update(zoo="DiM-S/2", hidden_size=256, depth=4)
    else:
        m.update(zoo="DiT-S/2", hidden_size=384, depth=12, num_heads=6)
    cell["image_size"] = 128
    if cell["entry"] == "sample":
        cell.update(images=3, num_steps=6)
        cell["check"]["block_rows"] = 4
    else:
        cell.update(batch=4, samples=64, num_workers=2)
        cell["check"]["block_rows"] = 2
    cell["model"] = model_fields(cell)
    return cell


def checks(cell):
    runner = sample if cell["entry"] == "sample" else train
    _, out, calls, _ = runner.run(cell, SEED, 2.0, False, "cpu")
    assert calls > 0
    return out


@pytest.mark.parametrize("name", ["dim-l2.sample-256", "dit-xl2.sample-512"])
def test_sound_run_is_correct(name):
    out = checks(narrow(name))
    assert all(c.ok for c in out), out


SOUND = {}


@pytest.mark.parametrize("name, fault", [
    (name, fault) for name in ("dim-l2.sample-256", "dim-l2.train-256")
    for fault in ("unchanged", "half", "altered")]
    + [("dim-l2.train-256", "ema")])
def test_fault_is_not_correct(name, fault, monkeypatch):
    if name not in SOUND:
        SOUND[name] = {c.name: c.value for c in checks(narrow(name))}
    cell = narrow(name)
    faults.plant(cell["entry"], fault, monkeypatch)
    out = checks(cell)
    assert not all(c.ok for c in out), out
    assert any(not c.ok and not c.value <= 3 * SOUND[name][c.name]
               for c in out), (out, SOUND[name])
