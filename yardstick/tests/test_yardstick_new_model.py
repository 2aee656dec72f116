"""A model that the harness was not written for, added by new files alone:
a two-convolution autoencoder trained by ``torch.optim.Adam(betas=(0.5,
0.9))`` with its own model file, reference, configuration, traffic, cell and
per-layer reader, in a copy of the yardstick's data folders and drivers.
The command runs its cell card-less, traced and untraced, and no harness
source names a model or a driver."""

import ast
import hashlib
import json
import shutil

import pytest

from yardstick import spec as specs
from yardstick.tests.conftest import make_cardless, small_cell

MODEL = '''
"""A two-convolution autoencoder, L1 reconstruction, torch.optim.Adam."""
from pathlib import Path

import torch

from yardstick import flops, inputs, spec

reference = spec.module("reference", "toy", Path(__file__).resolve().parents[1])
SMALL = {}


class Training:
    def __init__(self, cfg, traffic, data, stats, params, device, mesh_cfg=None):
        c = cfg["channels"]
        self.model = torch.nn.Sequential(torch.nn.Conv2d(3, c, 3, padding=1), torch.nn.ReLU(),
                                         torch.nn.Conv2d(c, 3, 3, padding=1)).to(device)
        self.model.load_state_dict(params, strict=True)
        _kind, self.b1, b2, eps = optimizer(cfg)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=cfg["learning_rate"], betas=(self.b1, b2),
                                    eps=eps)
        self.data = data

    def dispatch(self, idx):
        losses = []
        for rows in idx:
            x = batch(self.data, rows).permute(0, 3, 1, 2)
            self.opt.zero_grad()
            loss = (self.model(x) - x).abs().mean()
            loss.backward()
            self.opt.step()
            losses.append(loss.detach())
        return torch.stack(losses)

    def run(self, idx):
        return self.dispatch(idx).cpu().numpy()

    def first_gradient(self):
        return {n: self.opt.state[p]["exp_avg"] / (1.0 - self.b1) for n, p in self.model.named_parameters()}

    def parameters(self):
        return dict(self.model.named_parameters())


def make_data(n, cfg, seed, device):
    return inputs.images(n, seed, device, cfg["image_size"])[0], None


def batch(data, rows):
    return data.index_select(0, torch.from_numpy(rows).to(data.device))


def loss(params, batch, cfg, stats):
    return reference.loss(params, batch, cfg)


def optimizer(cfg):
    return "adam", 0.5, 0.9, 1e-8


def flop_per_item(cfg, kind):
    s, c = cfg["image_size"], cfg["channels"]
    return 3 * (flops.conv_flops(s, s, 3, c, 3, 3) + flops.conv_flops(s, s, c, 3, 3, 3))


def rows_per_item(cfg):
    return 7
'''

REFERENCE = '''
"""The toy autoencoder in plain PyTorch on a dict of parameters."""
import torch.nn.functional as F

from yardstick.reference.params import uniform_bound


def param_specs(cfg):
    c = cfg["channels"]
    b1, b2 = uniform_bound(3 * 9), uniform_bound(c * 9)
    return [("0.weight", (c, 3, 3, 3), "uniform", b1), ("0.bias", (c,), "uniform", b1),
            ("2.weight", (3, c, 3, 3), "uniform", b2), ("2.bias", (3,), "uniform", b2)]


def loss(p, x, cfg):
    x = x.permute(0, 3, 1, 2)
    h = F.relu(F.conv2d(x, p["0.weight"], p["0.bias"], padding=1))
    return (F.conv2d(h, p["2.weight"], p["2.bias"], padding=1) - x).abs().mean()
'''

READER = "def read(view, info, spec):\n    return getattr(info, spec['field'])\n"
COPIED = ("cells", "configs", "traffic", "layers", "drivers")
CELL = "toy_ae.train_toy"


def _digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for folder in COPIED for p in sorted((root / folder).rglob("*")) if p.is_file()}


def _write(path, text):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text if isinstance(text, str) else json.dumps(text))


@pytest.fixture
def toy_root(tmp_path):
    for folder in COPIED:
        shutil.copytree(specs.ROOT / folder, tmp_path / folder, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path)
    _write(tmp_path / "models" / "toy.py", MODEL)
    _write(tmp_path / "reference" / "toy.py", REFERENCE)
    _write(tmp_path / "configs" / "toy_ae.json", {
        "model": "toy", "channels": 8, "image_size": 16, "compute_dtype": "float32", "learning_rate": 1e-3})
    _write(tmp_path / "traffic" / "train_toy.json", {
        "driver": "train", "metric": "toy_images_per_s", "unit": "images/s", "flop_kind": "train",
        "n_train": 512, "batch_size": 32, "steps_per_dispatch": 2, "trace_seconds": 0.2})
    _write(tmp_path / "cells" / f"{CELL}.json", {
        "config": "toy_ae", "traffic": "train_toy", "chips": 1, "why": "a model added by files alone",
        "limits": {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-3}})
    _write(tmp_path / "layers" / "toy_info.py", READER)
    for metric, field in (("toy_flop.toy", "flop_per_item"), ("toy_rows.toy", "rows_per_item")):
        _write(tmp_path / "layers" / f"{metric}.json", {
            "reader": "toy_info", "field": field, "unit": "count", "better": "lower", "source": "device_trace",
            "layer": "toy", "moves": "toy_images_per_s"})
    _write(tmp_path / "layers" / "mfu.toy.json", {
        "unit": "%", "better": "higher", "source": "device_trace", "layer": "whole step",
        "moves": "toy_images_per_s"})
    yield tmp_path
    assert {k: v for k, v in _digest(tmp_path).items() if k in before} == before, "an existing file was edited"


@pytest.mark.parametrize("trace", [0, 1])
def test_yardstick_runs_a_model_added_by_files_alone(toy_root, monkeypatch, capsys, trace):
    run = make_cardless(monkeypatch, root=toy_root)
    assert run.main(["--workload", CELL, "--seed", str(2**31 + 99), "--seconds", "0.3", "--trace", str(trace)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    cell = small_cell(CELL, toy_root)
    if trace:
        model, cfg = cell.model(), cell.config
        assert line["metrics"]["toy_flop.toy"]["value"] == model.flop_per_item(cfg, "train") == 3 * 2 * 16 * 16 * 8 * 27 * 2
        assert line["metrics"]["toy_rows.toy"]["value"] == 7
        assert "mfu.toy" not in line["metrics"]          # a CPU has no peak to read
    else:
        assert set(line["metrics"]) == {"toy_images_per_s", "setup_s"}


def test_yardstick_reads_the_first_gradient_with_the_models_own_b1(toy_root):
    cell_spec = small_cell(CELL, toy_root)
    cell = cell_spec.driver()(cell_spec, 5, "cpu")
    cell.setup()
    cell.release()
    numbers = cell.numbers()
    assert numbers["grad_gap"] < 1e-5 and numbers["change_gap"] < 1e-4 and numbers["loss_gap"] < 1e-6
    # the same moment read with another model's b1 (0.9) is five times too large
    b1 = cell_spec.model().optimizer(cell_spec.config)[1]
    wrong = {n: g * (1.0 - b1) / (1.0 - 0.9) for n, g in cell.first_grad.items()}
    assert cell.numbers((cell.first_losses, wrong, cell.params3))["grad_gap"] > 1.0


def test_yardstick_harness_names_no_model_and_no_driver():
    """No table or branch of the harness is keyed by a model's or a driver's
    name: those names appear only in the data files that choose them."""
    models = {p.stem for p in (specs.ROOT / "models").glob("*.py")} - {"__init__"}
    drivers = {p.stem for p in (specs.ROOT / "drivers").glob("*.py")} - {"__init__"}
    assert {"vqvae", "gated_pixelcnn"} <= models and {"train", "extract"} <= drivers
    sources = [p for p in specs.ROOT.rglob("*.py")
               if not {"models", "reference", "tests"} & set(p.relative_to(specs.ROOT).parts)]
    assert specs.ROOT / "flops.py" in sources and specs.ROOT / "drivers" / "train.py" in sources
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert node.value not in models | drivers, (path, node.lineno, node.value)
