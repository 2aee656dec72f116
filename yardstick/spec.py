"""Finding a cell's files by name.

A cell ``<config>.<traffic>`` is ``cells/<name>.json`` (its configuration,
traffic, chips, why, and the limits of its check); the configuration is
``configs/<config>.json``, the traffic ``traffic/<traffic>.json``. The
per-layer metrics of the cell are every ``layers/<metric>.json`` whose
``moves`` is the end-to-end metric that the traffic reports. The code is
found the same way: the configuration's ``"model"`` names
``models/<model>.py``, the traffic's ``"driver"`` names
``drivers/<driver>.py``, a metric's reader ``layers/<reader>.py``. Nothing
here lists cells, configurations, traffic, models, drivers or metrics: a new
one is new files, under the root that the cell was loaded from.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
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
    root: Path = ROOT

    @property
    def metric(self) -> str:
        return self.traffic["metric"]

    def model(self):
        """The configuration's model file (``models/__init__.py`` says what it holds)."""
        return module("models", self.config["model"], self.root)

    def driver(self):
        """The class that runs the traffic (``drivers/__init__.py``)."""
        return module("drivers", self.traffic["driver"], self.root).CELL


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
    return Cell(name, int(cell["chips"]), config, traffic, cell["limits"], layers, root)


def module(folder: str, name: str, root: Path = ROOT) -> ModuleType:
    """``<root>/<folder>/<name>.py``, imported from its file."""
    if not NAME.match(name) or "." in name:
        raise ValueError(f"not a name of {folder}: {name!r}")
    spec = importlib.util.spec_from_file_location(f"yardstick.{folder}.{name}",
                                                  root / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, layer: dict, root: Path = ROOT) -> Callable:
    """The ``read`` function of a per-layer metric's reader file."""
    return module("layers", layer.get("reader", metric.split(".")[0]), root).read
