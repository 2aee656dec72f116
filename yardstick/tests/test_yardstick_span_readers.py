"""CPU tests of the readers of the program's spans (``layers/span_idle_ms.py``,
``layers/span_ms.py``) on a synthetic Chrome trace of two updates: the
caller's thread (1) opens the update's spans, autograd's thread (2) the
search's backward, the card's stream (0) runs the kernels."""

import pytest

from yardstick import run
from yardstick import spec as specs
from yardstick.trace import WINDOW_SPAN, view_from_events

STEPS = 2


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def _launch(ts, corr, tid=1):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 0.5, tid=tid, correlation=corr)


def _events(instrumented=True):
    forward = [_ev("user_annotation", "train.forward", 2, 38)] if instrumented else []
    return forward + [
        _ev("user_annotation", WINDOW_SPAN, 0, 100),
        _ev("user_annotation", "yardstick.steps_by_index", 1, 98),
        _ev("cpu_op", "aten::convolution", 3, 3), _launch(4, 1),
        _ev("user_annotation", "search.fma[16x8x4]", 10, 10), _launch(12, 2),
        _ev("user_annotation", "train.backward", 45, 35),
        _ev("user_annotation", "search.backward", 50, 10, tid=2), _launch(52, 3, tid=2),
        _ev("user_annotation", "parallel.mean", 82, 8),
        _ev("user_annotation", "parallel.psum", 84, 4), _launch(85, 4),
        _launch(89, 5),
        _ev("user_annotation", "parallel.psum", 92, 3), _launch(93, 6),
        _ev("kernel", "conv_kernel", 5, 3, tid=0, correlation=1),
        _ev("kernel", "nearest_code_kernel", 14, 2, tid=0, correlation=2),
        _ev("kernel", "gemm_f64", 55, 3, tid=0, correlation=3),
        _ev("kernel", "wgrad_kernel", 70, 2, tid=0),
        _ev("kernel", "ncclDevKernel_AllReduce", 86, 1, tid=0, correlation=4),
        _ev("kernel", "foreach_copy", 89.5, 0.5, tid=0, correlation=5),
        _ev("kernel", "ncclDevKernel_AllReduce", 93, 1, tid=0, correlation=6),
    ]


def _read(metric, view):
    cell = "gated_pixelcnn_cifar10.train_b1024" if metric.endswith(".prior") else "vqvae_cifar10.train_dp4_b2048"
    layer = specs.load_cell(cell).layers[metric]
    return specs.reader(metric, layer)(view, run.SliceInfo(STEPS, 512, 1, {}, 1.0, "float32", {}, 64), layer)


def test_yardstick_gaps_go_to_the_innermost_span():
    view = view_from_events(_events())
    gaps = dict(view.breakdown()["idle_gaps"])
    assert gaps["train.forward"] == pytest.approx(6e-6)          # 8..14: between the conv and the search
    assert gaps["search.fma[16x8x4]"] == pytest.approx(39e-6)     # 16..55: the caller still in the search
    assert gaps["train.backward"] == pytest.approx(26e-6)        # 58..70 and 72..86
    ms = lambda us: 1e-3 * us / STEPS  # noqa: E731
    assert _read("forward_idle_ms.train", view) == pytest.approx(ms(45))
    assert _read("forward_idle_ms.prior", view) == pytest.approx(ms(6))
    assert _read("backward_idle_ms.train", view) == _read("backward_idle_ms.prior", view) == pytest.approx(ms(26))


def test_yardstick_span_readers_find_nothing_without_the_spans():
    view = view_from_events(_events(instrumented=False))
    assert _read("forward_idle_ms.train", view) is None and _read("backward_idle_ms.prior", view) is None
    assert _read("search_ms_per_step.train", view) is not None   # the others read the spans that are there
    bare = view_from_events([e for e in _events() if e["cat"] != "user_annotation" or e["name"] == WINDOW_SPAN])
    assert all(_read(m, bare) is None for m in ("search_ms_per_step.train", "allreduce_ms_per_step.train",
                                                "psum_ms_per_step.train", "backward_idle_ms.train"))


def test_yardstick_span_idle_reads_zero_where_the_spans_hold_no_gap():
    view = view_from_events(_events())
    layer = dict(specs.load_cell("vqvae_cifar10.train_b256").layers["backward_idle_ms.train"], spans=["train.batch"])
    info = run.SliceInfo(STEPS, 512, 1, {}, 1.0, "float32", {}, 64)
    assert specs.reader("backward_idle_ms.train", layer)(view, info, layer) == 0.0


def test_yardstick_span_ms_reads_device_time_inside_the_spans():
    view = view_from_events(_events())
    ms = lambda us: 1e-3 * us / STEPS  # noqa: E731
    assert _read("search_ms_per_step.train", view) == pytest.approx(ms(2 + 3))     # forward and backward
    assert _read("allreduce_ms_per_step.train", view) == pytest.approx(ms(1 + 0.5))
    assert _read("psum_ms_per_step.train", view) == pytest.approx(ms(1))          # mean_'s own psum left out
    layer = specs.load_cell("vqvae_cifar10.train_dp4_b2048").layers["psum_ms_per_step.train"]
    every = {k: v for k, v in layer.items() if k != "except"}
    info = run.SliceInfo(STEPS, 512, 1, {}, 1.0, "float32", {}, 64)
    assert specs.reader("psum_ms_per_step.train", every)(view, info, every) == pytest.approx(ms(2))
