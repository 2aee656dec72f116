"""Helpers of the yardstick's CPU tests: a cell cut to a size that a test
run can hold (the widths of the configuration shrunk to its model file's
``SMALL``, the set, the batch and the chunks small), and a card-less drive of
the command."""

import pytest

from yardstick import spec as specs

_LOAD = specs.load_cell
CELLS = sorted(p.name[:-len(".json")] for p in (specs.ROOT / "cells").glob("*.json"))


def small_cell(name, root=specs.ROOT):
    cell = _LOAD(name, root)
    cell.config.update(cell.model().SMALL)
    t = cell.traffic
    for key, value in dict(n_train=512, n_images=300, batch_size=32 * t.get("n_data", 1)).items():
        if key in t:
            t[key] = value
    if "steps_per_dispatch" in t:
        t["steps_per_dispatch"] = 2
    t["trace_seconds"] = 0.2
    return cell


def make_cardless(monkeypatch, root=specs.ROOT):
    """Drive ``yardstick.run.main`` on the CPU at a small size, its cells
    loaded from ``root``: the look for a card is skipped and every rank runs
    on the CPU (gloo)."""
    import torch

    from yardstick import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "cpu")
    monkeypatch.setattr(run.specs, "load_cell", lambda name: small_cell(name, root))
    measure, ranks = run._measure, run._run_ranks
    monkeypatch.setattr(run, "_measure", lambda c, s, sec, tr, _dev, *a: measure(c, s, sec, tr, torch.device("cpu"), *a))
    monkeypatch.setattr(run, "_run_ranks", lambda *a: ranks(*a, device="cpu"))
    return run


@pytest.fixture
def cardless(monkeypatch):
    return make_cardless(monkeypatch)
