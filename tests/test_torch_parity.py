"""The port's convergence-fleet tool (``vqvae_tpu_torch/bench/parity.py``)
against the JAX tool (``tools/parity_5k.py``, imported read-only from its
file: ``tools/`` is no package) and the committed fleets in ``artifacts/``.

(a) the verdict arithmetic equals the JAX tool's, field by field within
    1e-12, on the reference fleet against the JAX fleets; the JAX fp32 fleet
    in the port's place reproduces ``artifacts/parity_5k.json["metrics"]``;
(b) ``run`` builds the JAX tool's ``VQVAEConfig`` and ``TrainConfig``, field
    by field, for each mode's flags (both trainers swapped, nothing trains);
(c) a real ``run --device cpu`` writes a file that the JAX tool's
    ``_final_window`` reads, with the JAX run's ``x_train_var``;
(d) ``FLEETS`` holds the pre-registered fleets, the shell script's flags and
    seeds, and ``fleet``'s plan names its files and skips existing ones;
(e) ``report`` writes nothing without ``--json`` and never under ``artifacts/``;
    it splits total loss into recon and the embedding term, and judges the
    EMA modes against the reference on recon only.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import shutil
import sys

import numpy as np
import pytest

from vqvae_tpu_torch.bench import parity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "artifacts")
METRIC_KEYS = [(key, lower) for key, _name, lower in parity.METRICS]


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("parity_5k", os.path.join(ROOT, "tools", "parity_5k.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _close(a, b, tol=1e-12):
    """Equal within ``tol`` for numbers, recursively for lists and dicts."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_close(a[k], b[k], tol) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y, tol) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return math.isclose(a, b, rel_tol=0, abs_tol=tol)
    return a == b


def _finals(paths, key):
    return [parity._final_window(p, key) for p in paths]


# -- (a) the verdict arithmetic --------------------------------------------------


@pytest.mark.parametrize("fleet", ["fp32", "high", "bf16", "ema", "ema_bf16"])
@pytest.mark.parametrize("key,lower", METRIC_KEYS)
def test_metric_verdict_is_the_jax_tools(jax_tool, fleet, key, lower):
    ref, jax_fp32 = jax_tool._seed_runs(ART)
    assert (ref, jax_fp32) == parity._seed_runs(ART) and len(ref) == 79 and len(jax_fp32) == 71
    paths = jax_fp32 if fleet == "fp32" else jax_tool._mode_fleets(ART)[fleet]
    assert fleet == "fp32" or paths == parity._mode_fleets(ART)[fleet]
    tf, jf = _finals(ref, key), _finals(paths, key)
    assert tf == [jax_tool._final_window(p, key) for p in ref]
    ours = parity._metric_verdict(tf, jf, lower_is_better=lower)
    theirs = jax_tool._metric_verdict(tf, jf, lower_is_better=lower)
    assert _close(ours, theirs), (ours, theirs)


def test_the_jax_fleet_in_the_ports_place_reproduces_parity_5k_json(tmp_path):
    """The JAX fp32 fleet, copied under the port's names, through ``report``:
    its fp32 verdicts against the reference are the committed metrics."""
    want = json.load(open(os.path.join(ART, "parity_5k.json")))["metrics"]
    _ref, jax_fp32 = parity._seed_runs(ART)
    for i, path in enumerate(jax_fp32, start=1):
        shutil.copy(path, tmp_path / parity.port_file("fp32", i))
    got = parity.report(str(tmp_path), ART)["modes"]["fp32"]["vs_reference"]
    assert _close(got, want), (got, want)
    same = {name: parity._metric_verdict(_finals(_ref, key), _finals(jax_fp32, key), lower)
            for key, name, lower in parity.METRICS}
    assert _close(same, want)


# -- (b) the configuration of a run ------------------------------------------------


def _capture_jax(jax_tool, monkeypatch, flags, tmp_path):
    import vqvae_tpu.data.datasets as jax_datasets
    import vqvae_tpu.train.vqvae_train as jax_train

    seen = {}

    def fake_train(vq_cfg, train_cfg, dataset=None):
        seen.update(vq=vq_cfg.to_dict(), train=train_cfg.to_dict(), dataset=dataset[3])
        return None, _History(), None

    monkeypatch.setattr(jax_train, "train_vqvae", fake_train)
    monkeypatch.setattr(jax_datasets, "load_dataset", lambda name, root: (None, None, 0.5, {"name": name,
                                                                                           "root": root}))
    monkeypatch.setattr(sys, "argv", ["parity_5k.py", "jax", "--seed", "7", "--steps", "3",
                                      "--out", str(tmp_path / "jax.npz"), *flags])
    assert jax_tool.main() == 0
    return seen


class _History:
    recon_errors = loss_vals = perplexities = [1.0, 2.0, 3.0]


def _capture_port(monkeypatch, flags, tmp_path):
    seen = {}

    def fake_train(vq_cfg, train_cfg, dataset=None, device="cuda"):
        seen.update(vq=vq_cfg.to_dict(), train=train_cfg.to_dict(), dataset=dataset[3], device=device)
        return None, _History(), None

    monkeypatch.setattr(parity, "train_vqvae", fake_train)
    monkeypatch.setattr(parity, "load_dataset", lambda name, root: (None, None, 0.5, {"name": name,
                                                                                      "root": root}))
    assert parity.main(["run", "--seed", "7", "--steps", "3", "--out", str(tmp_path / "port.npz"),
                        "--device", "cpu", *flags]) == 0
    return seen


@pytest.mark.parametrize("fleet", parity.FLEETS, ids=parity.MODES)
def test_run_builds_the_jax_tools_configs(jax_tool, monkeypatch, tmp_path, fleet):
    theirs = _capture_jax(jax_tool, monkeypatch, fleet.flags, tmp_path)
    ours = _capture_port(monkeypatch, fleet.flags, tmp_path)
    assert ours["vq"] == theirs["vq"] and ours["train"] == theirs["train"]
    assert ours["dataset"] == theirs["dataset"] == {"name": "CIFAR10", "root": "data"}
    assert ours["device"] == "cpu"
    assert ours["vq"]["share_residual_weights"] and ours["train"]["batch_size"] == 32
    assert ours["train"]["steps_per_dispatch"] == 50 and ours["train"]["save"] is False
    with np.load(tmp_path / "port.npz") as d, np.load(tmp_path / "jax.npz") as j:
        assert set(j.files) - {"backend"} <= set(d.files)
        for key in ("conv_precision", "compute_dtype", "quantizer_precision", "ema_codebook"):
            assert d[key] == j[key], key


# -- (c) a real run on the CPU ----------------------------------------------------


def test_a_real_run_is_read_by_the_jax_tool(jax_tool, tmp_path):
    out = str(tmp_path / "port_5k_seed1.npz")
    assert parity.main(["run", "--device", "cpu", "--steps", "4", "--batch_size", "4", "--seed", "1",
                        "--out", out]) == 0
    assert os.listdir(tmp_path) == ["port_5k_seed1.npz"]
    with np.load(out) as d, np.load(os.path.join(ART, "jax_5k.npz")) as j:
        for key in parity.CURVES:
            assert d[key].shape == (4,) and d[key].dtype == np.float32 and np.isfinite(d[key]).all()
        assert float(d["x_train_var"]) == float(j["x_train_var"])
        assert str(d["device"]) == "cpu" and "concurrent_runs" not in d.files  # the fleet's to write
        assert str(d["search"]) == "plain"  # the CPU's search, under every impl
        for key in parity.CURVES:
            assert jax_tool._final_window(out, key) == pytest.approx(float(np.mean(d[key])), rel=1e-7)


# -- (d) the fleets ---------------------------------------------------------------


def test_fleets_are_the_preregistered_ones():
    seeds20 = tuple(range(1, 21))
    assert [(f.mode, f.seeds) for f in parity.FLEETS] == [
        ("fp32", tuple(range(1, 41))), ("bf16", seeds20), ("ema", (1, 2, 3)), ("ema_bf16", (1, 2, 3)),
        ("high", seeds20)]
    # the other modes' flags and seeds are the shell script's
    script = open(os.path.join(ROOT, "tools", "run_precision_fleet.sh")).read().replace("\\\n", " ")
    loops = re.findall(r'for s in (\$\(seq 1 (\d+)\)|[\d ]+); do\s+run "artifacts/jax_5k_(\w+)_seed\$\{s\}\.npz"'
                       r' "\$s"([^\n]*)\n', script)
    shell = {}
    for seq, n, mode, flags in loops:
        seeds = tuple(range(1, int(n) + 1)) if n else tuple(int(s) for s in seq.split())
        shell[mode] = (seeds, " ".join(flags.split()))
    assert set(shell) == {"high", "bf16", "ema", "ema_bf16"}
    for f in parity.FLEETS[1:]:
        assert shell[f.mode] == (f.seeds, " ".join(f.flags)), f.mode
    assert parity.FLEETS[0].flags == ()


def test_fleet_plan_names_the_files_and_skips_existing_ones(tmp_path):
    todo, skipped = parity.plan(str(tmp_path))
    assert len(todo) == 86 and skipped == []
    names = [os.path.basename(p) for _f, _s, p in todo]
    assert names[:40] == [f"port_5k_seed{s}.npz" for s in range(1, 41)]
    assert names[40] == "port_5k_bf16_seed1.npz" and names[60:63] == [f"port_5k_ema_seed{s}.npz" for s in (1, 2, 3)]
    assert names[63] == "port_5k_ema_bf16_seed1.npz" and names[-1] == "port_5k_high_seed20.npz"
    (tmp_path / "port_5k_seed3.npz").write_bytes(b"")
    (tmp_path / "port_5k_high_seed3.npz").write_bytes(b"")
    todo, skipped = parity.plan(str(tmp_path), modes=("fp32", "ema"))
    assert [os.path.basename(p) for p in skipped] == ["port_5k_seed3.npz"]
    assert [(f.mode, s) for f, s, _p in todo] == [("fp32", s) for s in range(1, 41) if s != 3] + [
        ("ema", s) for s in (1, 2, 3)]
    argv = parity._run_argv(todo[-1][0], 3, todo[-1][2], "cuda")
    assert argv[1:4] == ["-m", "vqvae_tpu_torch.bench.parity", "run"] and argv[-1] == "--ema"
    assert argv[argv.index("--steps") + 1] == "5000" and argv[argv.index("--device") + 1] == "cuda"


def test_fleet_runs_each_seed_in_a_process_and_goes_on_past_a_failure(tmp_path, monkeypatch, capsys):
    """Each run is its own process, at most ``jobs`` at once; a failed run is
    printed, the others go on, the fleet exits non-zero; each written file
    gets the most runs that shared the card while it ran; a second fleet
    skips the files written and launches only the missing seed."""
    launched = []

    def argv(f, seed, path, device):
        launched.append((f.mode, seed))
        if seed == 2:
            return [sys.executable, "-c", "import sys; print('boom'); sys.exit(3)"]
        # seed 1 outlives seed 2's failure, so seed 3 runs beside it
        return [sys.executable, "-c", f"import time, numpy; time.sleep({3 if seed == 1 else 0}); "
                f"numpy.savez({path!r}, recon_errors=numpy.ones(3)); print('saved {seed}')"]

    monkeypatch.setattr(parity, "_run_argv", argv)
    assert parity.fleet(str(tmp_path), modes=("ema",), jobs=2, device="cpu") == 1
    printed = capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == ["port_5k_ema_seed1.npz", "port_5k_ema_seed3.npz"]
    assert "FAILED" in printed and "boom" in printed and "2 written" in printed and "1 failed" in printed
    assert launched == [("ema", 1), ("ema", 2), ("ema", 3)]
    for seed in (1, 3):
        with np.load(tmp_path / f"port_5k_ema_seed{seed}.npz") as d:
            assert int(d["concurrent_runs"]) == 2 and np.array_equal(d["recon_errors"], np.ones(3))
    assert parity.fleet(str(tmp_path), modes=("ema",), jobs=2, device="cpu") == 1
    assert launched[3:] == [("ema", 2)] and "skip" in capsys.readouterr().out


def test_fleet_and_run_refuse_the_jax_records(tmp_path):
    with pytest.raises(ValueError, match="artifacts"):
        parity.fleet(ART, device="cpu")
    with pytest.raises(ValueError, match="artifacts"):
        parity.run(1, os.path.join(ART, "port_5k_seed1.npz"), 4, 1, device="cpu")
    with pytest.raises(ValueError, match="unknown modes"):
        parity.fleet(str(tmp_path), modes=("fp16",), device="cpu")


# -- (e) report writes only where it is told ------------------------------------------


def _tree(path):
    return {os.path.join(b, n): os.stat(os.path.join(b, n)).st_mtime_ns
            for b, _d, names in os.walk(path) for n in names}


def test_report_writes_nothing_without_json(tmp_path, monkeypatch, capsys):
    port = tmp_path / "port"
    port.mkdir()
    for i, name in enumerate(("jax_5k_seed1.npz", "jax_5k_seed2.npz", "jax_5k_seed3.npz"), start=1):
        shutil.copy(os.path.join(ART, name), port / parity.port_file("fp32", i))
    shutil.copy(os.path.join(ART, "jax_5k_ema_seed1.npz"), port / parity.port_file("ema", 1))
    monkeypatch.chdir(tmp_path)
    before, before_here = _tree(ART), _tree(tmp_path)
    rc = parity.main(["report", "--port_dir", str(port), "--ref_dir", ART])
    assert rc in (0, 1)
    assert _tree(ART) == before and _tree(tmp_path) == before_here
    printed = capsys.readouterr().out
    assert "| fp32 | recon |" in printed and "| ema | perplexity |" in printed
    with pytest.raises(ValueError, match="artifacts"):
        parity.main(["report", "--port_dir", str(port), "--ref_dir", ART,
                     "--json", os.path.join(ART, "parity_port.json")])
    assert _tree(ART) == before
    out = tmp_path / "r" / "parity.json"
    parity.main(["report", "--port_dir", str(port), "--ref_dir", ART, "--json", str(out)])
    payload = json.load(open(out))
    assert set(payload) == {"criterion", "window", "port_dir", "ref_dir", "runs", "modes"}
    assert [(r["mode"], r["seed"]) for r in payload["runs"]] == [("fp32", 1), ("fp32", 2), ("fp32", 3),
                                                                 ("ema", 1)]
    fp32 = payload["modes"]["fp32"]
    assert fp32["n"] == 3 and fp32["route"] == "fma" and fp32["vs_reference"]["recon"]["n_torch"] == 79
    assert fp32["vs_jax"]["recon"]["n_torch"] == 71 and payload["modes"]["ema"]["vs_jax"]["recon"]["n_torch"] == 3
    assert set(fp32["ok"]) == {"vs_reference", "vs_jax"}
    assert _tree(ART) == before


@pytest.mark.parametrize(("device_type", "launched", "want"), [
    ("cpu", [], "plain"), ("cuda", [], "matmul"), ("cuda", ["fma"], "fma"), ("cuda", ["mma"], "mma"),
    ("cuda", ["mma", "fma"], "mma+fma"),
])
def test_a_run_records_the_route_of_its_search(device_type, launched, want):
    """What a run writes as ``search``: the kernels it launched, the matmul
    branch on a card where it launched none, the plain version on the CPU."""
    assert parity.search_route(device_type, launched) == want


def test_report_names_the_route_the_runs_recorded(tmp_path):
    """A run's ``search`` is its mode's route in the report; a file written
    before runs recorded one (here the JAX fleet's) ran the kernel."""
    for i, search in enumerate(("matmul", "matmul", None), start=1):
        with np.load(os.path.join(ART, f"jax_5k_seed{i}.npz")) as d:
            fields = {key: d[key] for key in d.files}
        if search is not None:
            fields["search"] = search
        np.savez(tmp_path / parity.port_file("fp32", i), **fields)
    assert parity.report(str(tmp_path), ART)["modes"]["fp32"]["route"] == "fma+matmul"
    os.remove(tmp_path / parity.port_file("fp32", 3))
    assert parity.report(str(tmp_path), ART)["modes"]["fp32"]["route"] == "matmul"


def test_report_splits_the_loss_and_describes_ema(tmp_path):
    """``embedding_loss`` is the verdict on total loss minus recon, outside
    ``ok``; the EMA modes get against the reference a recon verdict and
    means, no ``ok``, and their JAX verdicts in full."""
    for i, name in enumerate(("jax_5k_seed1.npz", "jax_5k_seed2.npz", "jax_5k_seed3.npz"), start=1):
        shutil.copy(os.path.join(ART, name), tmp_path / parity.port_file("fp32", i))
    for i in (1, 2, 3):
        shutil.copy(os.path.join(ART, f"jax_5k_ema_seed{i}.npz"), tmp_path / parity.port_file("ema", i))
    modes = parity.report(str(tmp_path), ART)["modes"]
    ref, jax_fp32 = parity._seed_runs(ART)
    port = sorted(str(p) for p in tmp_path.glob("port_5k_seed*.npz"))

    def split(paths):
        return [parity._final_window(p, "loss_vals") - parity._final_window(p, "recon_errors") for p in paths]

    fp32 = modes["fp32"]
    assert _close(fp32["embedding_loss"]["vs_reference"], parity._metric_verdict(split(ref), split(port)))
    assert _close(fp32["embedding_loss"]["vs_jax"], parity._metric_verdict(split(jax_fp32), split(port)))
    assert set(fp32["vs_reference"]) == set(fp32["vs_jax"]) == {"recon", "total_loss", "perplexity"}
    assert isinstance(fp32["ok"]["vs_reference"], bool) and isinstance(fp32["ok"]["vs_jax"], bool)
    ema = modes["ema"]
    ema_paths = sorted(str(p) for p in tmp_path.glob("port_5k_ema_seed*.npz"))
    assert set(ema["vs_reference"]) == {"recon", "total_loss_mean", "perplexity_mean"}
    assert _close(ema["vs_reference"]["recon"], parity._metric_verdict(_finals(ref, "recon_errors"),
                                                                       _finals(ema_paths, "recon_errors")))
    assert ema["vs_reference"]["perplexity_mean"] == pytest.approx(
        np.mean(_finals(ema_paths, "perplexities")), rel=1e-12)
    assert ema["ok"]["vs_reference"] is None and ema["embedding_loss"]["vs_reference"] is None
    assert set(ema["vs_jax"]) == {"recon", "total_loss", "perplexity"} and ema["ok"]["vs_jax"] is True


def test_compare_tells_same_bits(tmp_path):
    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    curves = {key: np.arange(5, dtype=np.float32) for key in parity.CURVES}
    np.savez(a, **curves)
    np.savez(b, **curves)
    assert parity.compare(str(a), str(b))["same"] and parity.main(["compare", str(a), str(b)]) == 0
    curves["loss_vals"] = curves["loss_vals"] + np.float32(1e-6)
    np.savez(b, **curves)
    out = parity.compare(str(a), str(b))
    assert not out["same"] and out["max_abs_diff"]["loss_vals"] > 0 and out["max_abs_diff"]["recon_errors"] == 0
