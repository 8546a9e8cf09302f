"""On the card, at each cell's own size: the control (the reference in
float8 products, with a bfloat16 sampler state, put in the port's place)
comes out not correct on three seeds, and so does each fault of a
training cell planted in the port.  Each reading is printed as a JSON
line, "perfbench-reading", so that the limits' upper readings can be
read off a run:

    python -m pytest -q -s perfbench/tests/test_perfbench_card.py
"""

import json

import pytest

from perfbench.common import benchmark, load_cell

CELLS = [w["name"] for w in benchmark()["workloads"]]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


def _reading(kind, cell, seed, checks):
    print(json.dumps({"perfbench-reading": kind, "cell": cell, "seed": seed,
                      **{c.name: c.value for c in checks}}), flush=True)


def _run(cell, seed, card, sut="port", seconds=None):
    import importlib

    c = load_cell(cell)
    runner = importlib.import_module(f"perfbench.entries.{c['entry']}")
    return runner.run(c, seed, seconds or 6.0, False, card, sut=sut)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(cell, seed, card):
    _, checks, _, _ = _run(cell, seed, card, sut="control")
    _reading("control", cell, seed, checks)
    assert not all(c.ok for c in checks)


@pytest.mark.card
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "ema"])
@pytest.mark.parametrize("seed", SEEDS)
def test_training_faults_are_not_correct(fault, seed, card, monkeypatch):
    from perfbench.tests import faults

    cells = [c for c in CELLS if load_cell(c)["entry"] == "train"]
    if not cells:
        pytest.skip("no training cell")
    faults.plant("train", fault, monkeypatch)
    for cell in cells:
        _, checks, _, _ = _run(cell, seed, card, seconds=3.0)
        _reading("fault:" + fault, cell, seed, checks)
        assert not all(c.ok for c in checks)
