"""CPU tests of the harness: names, finding files by name, the frozen FLOP
formulas, the result line, and what the process loads."""

import json
import math
import re
import shutil
import subprocess
import sys

import pytest

from yardstick import run
from yardstick import spec as specs
from yardstick.tests.conftest import CELLS

BENCHMARK = specs.ROOT.parent / "BENCHMARK.json"
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def _jsons(folder):
    return sorted((specs.ROOT / folder).glob("*.json"))


@pytest.mark.parametrize("folder", ["cells", "configs", "traffic", "layers"])
def test_yardstick_file_names_are_names(folder):
    for path in _jsons(folder):
        assert specs.NAME.match(path.name[:-len(".json")]), path


def test_yardstick_layer_units_and_readers():
    for path in _jsons("layers"):
        layer = json.loads(path.read_text())
        name = path.name[:-len(".json")]
        assert specs.UNIT.match(layer["unit"]), name
        assert layer["better"] in ("lower", "higher") and TEXT.match(layer["layer"]), name
        assert layer["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert callable(specs.reader(name, layer))


@pytest.mark.parametrize("name", CELLS)
def test_yardstick_cell_loads(name):
    cell = specs.load_cell(name)
    assert cell.chips in (1, 4) and cell.limits and cell.layers
    assert specs.UNIT.match(cell.traffic["unit"])
    assert all(layer["moves"] == cell.metric for layer in cell.layers.values())


def test_yardstick_benchmark_json_follows_the_rules():
    if not BENCHMARK.exists():
        pytest.skip("no BENCHMARK.json beside the yardstick")
    bench = json.loads(BENCHMARK.read_text())
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]] + [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in bench["workloads"]]:
        assert specs.NAME.match(name), name
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert specs.UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}" and TEXT.match(w["why"])
        cell = specs.load_cell(w["name"])
        assert cell.chips == w["chips"]
        for metric in bench["per_layer"]:
            if w["name"] in metric.get("workloads", []):
                assert metric["name"] in cell.layers, (w["name"], metric["name"])
    for c in bench["configs"]:
        assert (specs.ROOT.parent / c["file"]).exists() and TEXT.match(c["source"])


def test_yardstick_new_files_are_found_without_an_edit(tmp_path):
    for folder in ("cells", "configs", "traffic", "layers"):
        shutil.copytree(specs.ROOT / folder, tmp_path / folder)
    cfg = json.loads((tmp_path / "configs" / "vqvae_cifar10.json").read_text())
    (tmp_path / "configs" / "vqvae_wide.json").write_text(json.dumps({**cfg, "n_hiddens": 256}))
    traffic = json.loads((tmp_path / "traffic" / "train_b256.json").read_text())
    (tmp_path / "traffic" / "train_b512.json").write_text(json.dumps({**traffic, "batch_size": 512}))
    (tmp_path / "cells" / "vqvae_wide.train_b512.json").write_text(json.dumps(
        {"config": "vqvae_wide", "traffic": "train_b512", "chips": 1, "why": "a test",
         "limits": {"loss_gap": 1.0}}))
    (tmp_path / "layers" / "steps_seen.train.json").write_text(json.dumps(
        {"unit": "steps", "better": "higher", "source": "device_trace", "layer": "VQ-VAE trainer",
         "moves": "train_images_per_s"}))
    (tmp_path / "layers" / "steps_seen.py").write_text("def read(view, info, spec):\n    return info.steps\n")
    cell = specs.load_cell("vqvae_wide.train_b512", root=tmp_path)
    assert cell.config["n_hiddens"] == 256 and cell.traffic["batch_size"] == 512
    assert "steps_seen.train" in cell.layers and "mfu.train" in cell.layers
    assert specs.reader("steps_seen.train", cell.layers["steps_seen.train"], root=tmp_path)(
        None, run.SliceInfo(7, 0, 1, {}, 0.0, "float32", {}, 64), {}) == 7


@pytest.mark.parametrize("config", ["vqvae_cifar10", "gated_pixelcnn_cifar10"])
def test_yardstick_frozen_flops_equal_the_programs(config):
    from vqvae_tpu_torch.utils import flops as program_flops

    cfg = json.loads((specs.ROOT / "configs" / f"{config}.json").read_text())
    per_item = specs.module("models", cfg["model"]).flop_per_item
    if cfg["model"] == "vqvae":
        kw = {k: cfg[k] for k in ("in_channels", "n_hiddens", "n_residual_hiddens",
                                  "n_residual_layers", "embedding_dim", "n_embeddings")}
        assert per_item(cfg, "train") == program_flops.train_step_flops_per_image(**kw)
        assert per_item(cfg, "encode") == program_flops.encode_quantize_flops_per_image(**kw)
        assert per_item(cfg, "train") == 265_289_728
    else:
        kw = {k: cfg[k] for k in ("img_dim", "dim", "n_layers", "input_dim")}
        assert per_item(cfg, "prior") == \
            program_flops.pixelcnn_train_step_flops_per_grid(**kw) == 684_195_840


def _last_line(capsys):
    out = capsys.readouterr()
    return json.loads(out.out.strip().splitlines()[-1]), out.err.strip().splitlines()


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_yardstick_result_line(cardless, capsys, name, trace):
    assert cardless.main(["--workload", name, "--seed", str(2**31 + 12345), "--seconds", "0.5",
                          "--trace", str(trace)]) == 0
    line, err = _last_line(capsys)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[:5] == keys and list(line)[-1] == "checks"
    assert set(line) == set(keys) | {"checks"} | ({"breakdown"} if trace else set())
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    cell = specs.load_cell(name)
    if trace:
        assert set(line["metrics"]) <= set(cell.layers) and "idle_share" in " ".join(line["metrics"])
        assert line["device"]["window_s"] > 0
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(line["metrics"]) == {cell.metric, "setup_s"}
        assert all(m["value"] > 0 for m in line["metrics"].values())
    assert err[-len(cell.limits):] == [
        f"check {k} {line['checks'][k]['value']!r} limit {line['checks'][k]['limit']!r}" for k in cell.limits]


def test_yardstick_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_yardstick_refuses_with_the_jax_package_loaded(cardless, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "vqvae_tpu", type(sys)("vqvae_tpu"))
    assert cardless.main(["--workload", "vqvae_cifar10.train_b256", "--seed", "3", "--seconds", "0.2"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "vqvae_tpu" in out.err


def test_yardstick_loads_no_jax():
    """A whole small run in a fresh process, then the names of every loaded
    module compared by whole top-level names."""
    code = (
        "import sys, json\n"
        "import pytest\n"
        "from yardstick.tests import conftest\n"
        "from yardstick import run, control\n"
        "mp = pytest.MonkeyPatch()\n"
        "conftest.make_cardless(mp)\n"
        "assert run.main(['--workload', 'vqvae_cifar10.extract_b4096', '--seed', '5', '--seconds', '0.2']) == 0\n"
        "print(json.dumps(run.forbidden_modules()))\n"
    )
    root = specs.ROOT.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    assert "vqvae_tpu" in run.FORBIDDEN and "jax" in run.FORBIDDEN


def test_yardstick_sources_import_neither_jax_nor_the_program_in_the_reference():
    for path in specs.ROOT.rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax|vqvae_tpu)\b(?!_torch)", text, re.M), path
        if "reference" in path.parts:
            assert "vqvae_tpu_torch" not in text, path


def test_yardstick_trace_view_reads_a_chrome_trace():
    from yardstick.trace import WINDOW_SPAN, view_from_events

    ev = lambda cat, name, ts, dur, tid=1, **args: {  # noqa: E731
        "ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}
    events = [
        ev("user_annotation", WINDOW_SPAN, 0, 100),
        ev("user_annotation", "yardstick.steps_by_index", 1, 90),
        ev("cpu_op", "aten::convolution", 2, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 3, 1, correlation=7),
        ev("cpu_op", "aten::copy_", 40, 20),
        ev("kernel", "conv_kernel", 20, 10, tid=0, correlation=7),
        ev("kernel", "other", 25, 10, tid=0, correlation=8),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 50, 5, tid=0),
        ev("kernel", "late", 200, 5, tid=0),
    ]
    view = view_from_events(events)
    assert view.window_s == pytest.approx(1e-4) and view.busy_s == pytest.approx(20e-6)
    assert view.ops[0].ancestors == (WINDOW_SPAN, "yardstick.steps_by_index", "aten::convolution")
    assert math.isclose(sum(s for _, s in view.gaps), 80e-6)
    assert dict(view.gaps)["yardstick.steps_by_index / aten::copy_"] == pytest.approx(45e-6)
    layer = specs.load_cell("gated_pixelcnn_cifar10.train_b1024").layers["conv_ms_per_step.prior"]
    info = run.SliceInfo(2, 512, 1, {}, 1.0, "float32", {}, 64)
    assert specs.reader("conv_ms_per_step.prior", layer)(view, info, layer) == pytest.approx(1e-5 / 2 * 1e3)


class _CountingCell:
    """Units that carry their own number, read back in order."""

    def __init__(self):
        self.queued = self.read = 0

    def unit(self):
        import torch

        self.queued += 1
        return 1, 2, torch.tensor([float(self.queued)])

    def settle(self, out):
        self.read += 1
        assert out[0] == self.read


@pytest.mark.parametrize("trace_seconds", [None, 0.02])
def test_yardstick_window_reads_every_unit_it_queued(trace_seconds):
    """The window reads results behind the work, and still reads every unit
    it queued, in order, before its clock stops; the traced slice too."""
    cell = _CountingCell()
    window = run.Window(cell, 0.1, trace_seconds, on_card=False)
    window.run()
    queued = cell.queued - (trace_seconds is not None)     # the profiler's own warm-up unit
    assert cell.read == cell.queued and not window.pending
    assert window.steps == queued > run.AHEAD and window.items == 2 * queued
    assert window.elapsed >= 0.1
    if trace_seconds is not None:
        assert 0 < window.slice_steps < window.steps and window.view is not None


def test_yardstick_needs_the_program(tmp_path):
    """Beside BENCHMARK.json and the yardstick alone, with no program to
    measure, a run fails and prints no result."""
    shutil.copytree(specs.ROOT, tmp_path / "yardstick", ignore=shutil.ignore_patterns("__pycache__"))
    if BENCHMARK.exists():
        shutil.copy(BENCHMARK, tmp_path / "BENCHMARK.json")
    code = (
        "import sys, pytest\n"
        "from yardstick.tests import conftest\n"
        "conftest.make_cardless(pytest.MonkeyPatch())\n"
        "from yardstick import run\n"
        "sys.exit(run.main(['--workload', 'vqvae_cifar10.train_b256', '--seed', '9', '--seconds', '0.2']))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "vqvae_tpu_torch" in proc.stderr
