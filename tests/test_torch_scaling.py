"""Weak scaling of encode + quantize over ranks (``vqvae_tpu_torch/bench/scaling.py``,
the port of ``tools/bench_scaling.py``): the payload built from rows against
the JAX tool's own ``main`` on the same rows, and the worker at one and two
gloo ranks (spawned processes, a small width, each with a time limit)."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import time

import pytest

from vqvae_tpu_torch.bench import scaling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
RATES = {1: 3000.0, 2: 2950.0, 4: 2500.0, 8: 1900.0}


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_scaling", os.path.join(ROOT, "tools", "bench_scaling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_payload(tmp_path, monkeypatch) -> dict:
    """The JAX tool's ``main`` on fixed rows (its workers replaced by the rows)."""
    tool = _jax_tool()
    monkeypatch.setattr(tool, "launch_worker", lambda backend, n: {
        "backend": backend, "n_devices": n, "global_batch": 128 * n, "images_per_sec": RATES[n]})
    out = tmp_path / "jax_scaling.json"
    monkeypatch.setattr(sys, "argv", ["bench_scaling.py", "--out", str(out)])
    assert tool.main() == 0
    return json.load(open(out))


def test_payload_has_the_jax_tools_fields_and_values(tmp_path, monkeypatch):
    jax = _jax_payload(tmp_path, monkeypatch)
    rows = [{"device": "cpu", "n_ranks": n, "global_batch": 128 * n, "images_per_sec": RATES[n]}
            for n in (1, 2, 4, 8)]
    port = scaling.payload(rows, [], os.cpu_count(), "cpu")
    for key, value in jax.items():
        name = scaling.JAX_NAMES.get(key, key)
        assert name in port, f"the JAX field {key} ({name}) is missing"
        if key in ("host_cpu_cores", "baseline_target", "min_flat_throughput_ratio_within_cores",
                   "min_flat_throughput_ratio_all", "tpu_1chip"):
            assert port[name] == value, key
    for j_row, p_row in zip(jax["cpu_virtual_mesh"], port["cpu_ranks"]):
        assert {scaling.JAX_NAMES.get(k, k) for k in j_row} <= set(p_row)
        for key in ("global_batch", "images_per_sec", "flat_throughput_ratio", "host_oversubscribed"):
            assert p_row[key] == j_row[key], key
        assert p_row["n_ranks"] == j_row["n_devices"]
    assert "scaling_efficiency" not in json.dumps(port["cpu_ranks"])


def test_card_rows_get_the_scaling_efficiency():
    cpu = [{"device": "cpu", "n_ranks": 1, "global_batch": 128, "images_per_sec": 100.0}]
    card = [{"device": "cuda", "n_ranks": n, "global_batch": 128 * n, "images_per_sec": rate}
            for n, rate in ((1, 1000.0), (2, 1800.0), (4, 3200.0))]
    port = scaling.payload(cpu, card, 8, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert [r["scaling_efficiency"] for r in port["card_rows"]] == pytest.approx([1.0, 0.9, 0.8])
    assert port["card_1chip"]["images_per_sec"] == 1000.0 and port["card"].startswith("NVIDIA")
    assert scaling.payload(cpu, [], 8, "cpu")["card_1chip"] is None


_RANK = """
import json, sys
sys.path.insert(0, {root!r})
from vqvae_tpu_torch.bench import scaling
from vqvae_tpu_torch.config import VQVAEConfig
cfg = VQVAEConfig(n_hiddens=16, n_residual_hiddens=8, embedding_dim=16, n_embeddings=64)
row = scaling.worker("cpu", {n}, {rank}, "tcp://127.0.0.1:{port}", cfg=cfg, iters=(1, 2))
print(json.dumps(row))
"""


@pytest.mark.parametrize("n", [1, 2])
def test_worker_on_gloo_ranks(n):
    port = scaling.free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _RANK.format(root=ROOT, n=n, rank=r, port=port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * n, [err[-2000:] for _out, err in outs]
    rows = [json.loads(out.strip().splitlines()[-1]) for out, _err in outs]
    assert rows[1:] == [None] * (n - 1)  # rank 0 alone reports
    row = rows[0]
    assert row["device"] == "cpu" and row["n_ranks"] == n and row["global_batch"] == 128 * n
    assert math.isfinite(row["images_per_sec"]) and row["images_per_sec"] > 0
    assert row["launches"] == {"mma": 0, "fma": 0}


def _tool_workers() -> list:
    """Processes of this machine running the tool's ``worker`` command."""
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if b"vqvae_tpu_torch.bench.scaling" in argv and b"worker" in argv:
            found.append(int(pid))
    return found


def test_a_group_past_its_limit_is_killed():
    """Two full-width ranks cannot finish in 2 s: the limit raises, and no
    worker process outlives the call."""
    t0 = time.monotonic()
    with pytest.raises(subprocess.TimeoutExpired):
        scaling.launch_workers("cpu", 2, timeout=2)
    assert time.monotonic() - t0 < 60
    assert _tool_workers() == []


def test_the_tool_refuses_a_missing_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scaling.main([])
