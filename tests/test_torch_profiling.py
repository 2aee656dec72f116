"""The port's tracing (``utils/profiling.py``): the span primitive, the spans
of the training update, and the ``profile`` command, on the CPU.

This file imports neither JAX nor the JAX package, so its ``gpu`` tests run
on a card with
    python -m pytest --noconftest -m gpu tests/test_torch_profiling.py
and skip themselves, inside the test, where there is none. The trace is a
Chrome trace (``*.pt.trace.json``); the tests read its event names.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import pytest
import torch

from vqvae_tpu_torch import cli
from vqvae_tpu_torch.config import PixelCNNConfig, TrainConfig, VQVAEConfig
from vqvae_tpu_torch.data.datasets import ArrayDataset
from vqvae_tpu_torch.ops import quantizer
from vqvae_tpu_torch.parallel import mesh as mesh_module
from vqvae_tpu_torch.parallel.mesh import Mesh, make_mesh
from vqvae_tpu_torch.train.pixelcnn_train import PixelCNNTrainer
from vqvae_tpu_torch.train.vqvae_train import VQVAETrainer
from vqvae_tpu_torch.utils import profiling
from vqvae_tpu_torch.utils.profiling import annotate, profile_trace

TINY = ["--n_hiddens", "16", "--n_residual_hiddens", "8", "--n_embeddings", "32", "--embedding_dim", "8"]


def _trace_names(trace_dir) -> set:
    files = glob.glob(os.path.join(str(trace_dir), "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return {e.get("name", "") for e in json.load(f)["traceEvents"]}


def test_profile_trace_holds_the_annotations(tmp_path):
    with profile_trace(str(tmp_path / "trace")) as prof:
        for i in range(3):
            with annotate(f"train_step_{i}"):
                torch.ones(64, 64) @ torch.ones(64, 64)
        with annotate(lambda: "built_name"):
            torch.ones(8).sum()
    names = _trace_names(tmp_path / "trace")
    assert {"train_step_0", "train_step_1", "train_step_2", "built_name"} <= names
    assert any("mm" in n for n in names)
    assert any(e.key == "train_step_0" for e in prof.key_averages())


def test_profile_command_on_the_cpu(tmp_path, capsys):
    trace = tmp_path / "trace"
    rc = cli.main(["profile", "--device", "cpu", *TINY, "--batch_size", "8", "--profile_steps", "3",
                   "--trace_dir", str(trace), "--data_dir", str(tmp_path / "no_data")])
    assert rc == 0
    assert f"Wrote a torch.profiler trace of 3 steps to {trace}" in capsys.readouterr().out
    names = _trace_names(trace)
    assert {f"train_step_{i}" for i in range(3)} <= names and "train_step_3" not in names
    assert any("convolution" in n for n in names)
    assert {"train.batch", "train.forward", "search.plain[512x32x8]", "train.backward", "search.backward",
            "Optimizer.step#TorchAmsgrad.step"} <= names


def test_profile_command_refuses_a_missing_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["profile", *TINY, "--trace_dir", str(tmp_path / "t"), "--data_dir", str(tmp_path)])
    assert not (tmp_path / "t").exists()


@pytest.mark.gpu
def test_profile_command_on_the_card(tmp_path):
    """On a card the trace holds the steps and the search kernel, one launch
    a step and one for the warm-up step outside the trace. The kernel is
    asked for: under "auto" the fp32 search at batch 32 (2,048 rows) takes
    the matmul branch (``ops/quantizer.py::_auto_impl``). The traced steps
    replay the update's graph, captured after the warm-up step, so the
    search opens no span of its own there."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from vqvae_tpu_torch.ops import cuda_quantizer

    cuda_quantizer.reset_launch_counts()
    trace = tmp_path / "trace"
    assert cli.main(["profile", "--batch_size", "32", "--profile_steps", "4", "--trace_dir", str(trace),
                     "--data_dir", str(tmp_path / "no_data"), "--quantizer_impl", "pallas"]) == 0
    names = _trace_names(trace)
    assert {f"train_step_{i}" for i in range(4)} <= names
    assert any("nearest_code" in n for n in names)
    assert any(n.startswith("cudaGraphLaunch") for n in names)
    assert cuda_quantizer.launches_by_route == {"mma": 0, "fma": 5}


# -- the span primitive --------------------------------------------------------


def test_annotate_without_a_profiler_makes_no_range_and_no_name(monkeypatch):
    def refused(*_a, **_k):
        raise AssertionError("record_function entered with no profiler running")

    def name():
        raise AssertionError("a span's name built with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    assert not torch.autograd._profiler_enabled()
    assert annotate("train.forward") is annotate(name) is profiling._OFF
    with annotate(name), annotate(name):
        pass


@pytest.mark.parametrize("impl, precision, d, route", [
    ("plain", "highest", 64, "plain"), ("jnp", "highest", 64, "matmul"),
    ("pallas", "highest", 64, "fma"), ("pallas", "default", 64, "mma")])
def test_search_span_names_the_route(impl, precision, d, route):
    assert quantizer._route_name(impl, precision, d) == route


# -- the spans of the training update (CPU) ------------------------------------


def _profiled(run):
    """The user spans of a profiled call of ``run``: name -> [(start, end,
    thread)]."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    spans = {}
    for e in prof.events():
        spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end, e.thread))
    return spans


def _inside(spans, inner, outer) -> bool:
    """Every ``inner`` span lies within an ``outer`` span of its thread."""
    return all(any(s0 <= i0 and i1 <= s1 and t == it for s0, s1, t in spans[outer])
               for i0, i1, it in spans[inner])


def test_vqvae_steps_by_index_opens_the_update_spans():
    cfg = VQVAEConfig(n_hiddens=16, n_residual_hiddens=8, n_embeddings=32, embedding_dim=8)
    trainer = VQVAETrainer(cfg, TrainConfig(batch_size=4), device="cpu")
    state = trainer.init_state()
    trainer.stage_dataset(np.random.default_rng(0).random((12, 32, 32, 3), dtype=np.float32))
    idx = np.arange(8).reshape(2, 4)
    spans = _profiled(lambda: trainer.steps_by_index(state, idx))
    search = "search.plain[256x32x8]"
    for name, count in [("train.batch", 3), ("train.forward", 2), (search, 2), ("train.backward", 2),
                        ("search.backward", 2), ("Optimizer.step#TorchAmsgrad.step", 2)]:
        assert len(spans.get(name, [])) == count, name
    assert _inside(spans, search, "train.forward")
    assert _inside(spans, "search.backward", "train.backward")   # one thread on the CPU
    assert not any(n.startswith("parallel.") for n in spans)


def test_prior_steps_by_index_opens_the_update_spans():
    trainer = PixelCNNTrainer(PixelCNNConfig(input_dim=16, dim=16, n_layers=2, n_classes=10, img_dim=4),
                              TrainConfig(batch_size=4), device="cpu")
    state = trainer.init_state()
    rng = np.random.default_rng(1)
    data = ArrayDataset(rng.integers(0, 16, (12, 4, 4)).astype(np.int32),
                        rng.integers(0, 10, (12,)).astype(np.int32))
    trainer.stage_dataset(data, data)
    spans = _profiled(lambda: trainer.steps_by_index(state, np.arange(8).reshape(2, 4)))
    for name, count in [("train.batch", 3), ("train.forward", 2), ("train.backward", 2),
                        ("Optimizer.step#Adam.step", 2)]:
        assert len(spans.get(name, [])) == count, name
    assert not any(n.startswith(("search.", "parallel.")) for n in spans)


def test_mesh_opens_no_span_off_the_distributed_path():
    mesh, grads = make_mesh(), [torch.ones(3), torch.ones(2, 2)]
    assert not mesh.distributed
    spans = _profiled(lambda: (mesh.mean_(grads, "world"), mesh.psum(torch.ones(4), "data")))
    assert not any(n.startswith("parallel.") for n in spans)
    assert [g.tolist() for g in grads] == [[1.0] * 3, [[1.0] * 2] * 2]


def test_mesh_spans_on_the_distributed_path(monkeypatch):
    """``mean_`` holds the cat, its ``psum`` and the copy-back in
    ``parallel.mean``; every all-reduce is in ``parallel.psum``."""
    reduced = []
    monkeypatch.setattr(mesh_module.dist, "all_reduce",
                        lambda t, group=None: reduced.append(t.numel()) or t.mul_(2))
    mesh = Mesh(n_data=2, n_code=1, data=0, code=0, distributed=True)
    grads = [torch.ones(3), torch.ones(2, 2)]
    spans = _profiled(lambda: (mesh.mean_(grads, "world"), mesh.psum(torch.ones(4), "data")))
    assert reduced == [7, 4] and all(g.eq(1.0).all() for g in grads)
    assert len(spans["parallel.mean"]) == 1 and len(spans["parallel.psum"]) == 2
    (m0, m1, _), = spans["parallel.mean"]
    assert [m0 <= p0 and p1 <= m1 for p0, p1, _ in spans["parallel.psum"]] == [True, False]


@pytest.mark.gpu
def test_search_backward_runs_on_autograd_thread_on_the_card(tmp_path):
    """On a card the search's backward (the one-hot DGEMM) of an eager update
    is launched under ``search.backward`` from autograd's device thread, not
    the caller's; at batch 256 the forward's route is the ``fma`` kernel at
    16,384 rows."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from yardstick.trace import WINDOW_SPAN, view_from_events

    trainer = VQVAETrainer(VQVAEConfig(), TrainConfig(batch_size=256), device="cuda")
    trainer._update = trainer._eager_update      # a replayed update opens no span inside the graph
    state = trainer.init_state()
    trainer.stage_dataset(np.random.default_rng(0).random((512, 32, 32, 3), dtype=np.float32))
    idx = np.arange(512).reshape(2, 256)
    trainer.steps_by_index(state, idx)            # the first cuDNN calls and the kernels' load
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            trainer.steps_by_index(state, idx)
            torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    threads = {e["name"]: e["tid"] for e in events if e.get("cat") == "user_annotation"}
    assert "search.fma[16384x512x64]" in threads
    assert threads["search.backward"] != threads["train.forward"]
    view = view_from_events(events)
    launched = [op for op in view.ops if "search.backward" in op.ancestors]
    assert any("gemm" in op.name.lower() for op in launched), [op.name for op in launched]
    assert any("train.forward" in op.ancestors for op in view.ops)
