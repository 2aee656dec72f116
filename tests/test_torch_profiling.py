"""The port's tracing and timing (``utils/profiling.py``) and the ``profile``
command on the CPU, beside the JAX package's ``step_timer``.

This file imports neither JAX nor the JAX package, so its ``gpu`` test runs
on a card with
    python -m pytest --noconftest -m gpu tests/test_torch_profiling.py
and skips itself, inside the test, where there is none. The trace is a
Chrome trace (``*.pt.trace.json``); the tests read its event names.
"""

from __future__ import annotations

import glob
import json
import os

import pytest
import torch

from vqvae_tpu_torch import cli
from vqvae_tpu_torch.utils.profiling import annotate, profile_trace, step_timer

TINY = ["--n_hiddens", "16", "--n_residual_hiddens", "8", "--n_embeddings", "32", "--embedding_dim", "8"]


def _trace_names(trace_dir) -> set:
    files = glob.glob(os.path.join(str(trace_dir), "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return {e.get("name", "") for e in json.load(f)["traceEvents"]}


def test_step_timer_fences_every_tensor_of_a_tree():
    copied = []

    class Watched(torch.Tensor):
        def cpu(self, *a, **k):
            copied.append(self.shape)
            return super().cpu(*a, **k)

    tree = {"a": torch.ones(256, 256) @ torch.ones(256, 256),
            "b": [1, torch.zeros(3).as_subclass(Watched)], "c": "text"}
    with step_timer() as t:
        t.fence(tree)
    assert t.seconds is not None and t.seconds > 0
    assert copied == [torch.Size([3])]


def test_step_timer_without_a_fence_still_times():
    with step_timer() as t:
        pass
    assert t.seconds >= 0.0


def test_profile_trace_holds_the_annotations(tmp_path):
    with profile_trace(str(tmp_path / "trace")) as prof:
        for i in range(3):
            with annotate(f"train_step_{i}"):
                torch.ones(64, 64) @ torch.ones(64, 64)
        with annotate("with_nvtx", nvtx=True):  # no card here: a plain range
            torch.ones(8).sum()
    names = _trace_names(tmp_path / "trace")
    assert {"train_step_0", "train_step_1", "train_step_2", "with_nvtx"} <= names
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
    the matmul branch (``ops/quantizer.py::_auto_impl``)."""
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
    assert cuda_quantizer.launches_by_route == {"mma": 0, "fma": 5}
