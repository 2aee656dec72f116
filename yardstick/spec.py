"""Finding a cell's files by name.

A cell ``<config>.<traffic>`` is ``cells/<name>.json`` (its configuration,
traffic, chips, why, and the limits of its check); the configuration is
``configs/<config>.json``, the traffic ``traffic/<traffic>.json``. The
per-layer metrics of the cell are every ``layers/<metric>.json`` whose
``moves`` is the end-to-end metric that the traffic reports. Nothing here
lists cells, configurations, traffic or metrics: a new one is new files.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    layers: Dict[str, dict] = field(default_factory=dict)

    @property
    def metric(self) -> str:
        return self.traffic["metric"]


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    if not NAME.match(name):
        raise ValueError(f"not a cell name: {name!r}")
    cell = _read(root / "cells" / f"{name}.json")
    config = _read(root / "configs" / f"{cell['config']}.json")
    traffic = _read(root / "traffic" / f"{cell['traffic']}.json")
    layers = {}
    for path in sorted((root / "layers").glob("*.json")):
        layer = _read(path)
        if layer["moves"] == traffic["metric"]:
            layers[path.name[:-len(".json")]] = layer
    return Cell(name, int(cell["chips"]), config, traffic, cell["limits"], layers)


def reader(metric: str, layer: dict, root: Path = ROOT) -> Callable:
    """The ``read`` function of a per-layer metric's reader file."""
    module = layer.get("reader", metric.split(".")[0])
    if not NAME.match(module) or "." in module:
        raise ValueError(f"not a reader name: {module!r}")
    spec = importlib.util.spec_from_file_location(f"yardstick.layers.{module}",
                                                  root / "layers" / f"{module}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
