"""CPU tests of the readers of the program's spans (``layers/span_idle_ms.py``,
``layers/span_ms.py``) and of kernels by name (``layers/kernel_ms.py``) on a
synthetic Chrome trace of two updates: the caller's thread (1) opens the
update's spans, autograd's thread (2) the search's backward, the card's
stream (0) runs the kernels."""

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
        _ev("kernel", "sm90_xmma_gemm_f64f64_f64f64_f64_nt_n_cublas", 55, 3, tid=0, correlation=3),
        _ev("kernel", "void (anonymous namespace)::conv_wgrad_kernel<128, 128>(float const*)", 70, 2, tid=0),
        _ev("kernel", "ncclDevKernel_AllReduce", 86, 1, tid=0, correlation=4),
        _ev("kernel", "foreach_copy", 89.5, 0.5, tid=0, correlation=5),
        _ev("kernel", "ncclDevKernel_AllReduce", 93, 1, tid=0, correlation=6),
    ]


def _info():
    return run.SliceInfo(STEPS, 512, 1, {}, 1.0, "float32", {}, 64)


def _read(metric, view):
    cell = "gated_pixelcnn_cifar10.train_b1024" if metric.endswith(".prior") else "vqvae_cifar10.train_dp4_b2048"
    layer = specs.load_cell(cell).layers[metric]
    return specs.reader(metric, layer)(view, _info(), layer)


def test_yardstick_gaps_go_to_the_innermost_span():
    view = view_from_events(_events())
    gaps = dict(view.breakdown()["idle_gaps"])
    assert gaps["train.forward"] == pytest.approx(6e-6)          # 8..14: between the conv and the search
    assert gaps["search.fma[16x8x4]"] == pytest.approx(39e-6)     # 16..55: the caller still in the search
    assert gaps["train.backward"] == pytest.approx(26e-6)        # 58..70 and 72..86
    ms = lambda us: 1e-3 * us / STEPS  # noqa: E731
    assert _read("forward_idle_ms.prior", view) == pytest.approx(ms(6))
    assert _read("backward_idle_ms.prior", view) == pytest.approx(ms(26))
    layer = dict(specs.load_cell("gated_pixelcnn_cifar10.train_b1024").layers["forward_idle_ms.prior"],
                 spans=["train.forward", "search."])
    assert specs.reader("forward_idle_ms.prior", layer)(view, _info(), layer) == pytest.approx(ms(45))


def test_yardstick_span_readers_find_nothing_without_the_spans():
    view = view_from_events(_events(instrumented=False))
    assert _read("forward_idle_ms.prior", view) is None and _read("backward_idle_ms.prior", view) is None
    assert _read("allreduce_ms_per_step.train", view) is not None   # the others read the spans that are there
    bare = view_from_events([e for e in _events() if e["cat"] != "user_annotation" or e["name"] == WINDOW_SPAN])
    assert all(_read(m, bare) is None for m in ("allreduce_ms_per_step.train", "psum_ms_per_step.train",
                                                "backward_idle_ms.prior"))


def test_yardstick_span_idle_reads_zero_where_the_spans_hold_no_gap():
    view = view_from_events(_events())
    layer = dict(specs.load_cell("gated_pixelcnn_cifar10.train_b1024").layers["backward_idle_ms.prior"],
                 spans=["train.batch"])
    assert specs.reader("backward_idle_ms.prior", layer)(view, _info(), layer) == 0.0


def test_yardstick_span_ms_reads_device_time_inside_the_spans():
    view = view_from_events(_events())
    ms = lambda us: 1e-3 * us / STEPS  # noqa: E731
    assert _read("allreduce_ms_per_step.train", view) == pytest.approx(ms(1 + 0.5))
    assert _read("psum_ms_per_step.train", view) == pytest.approx(ms(1))          # mean_'s own psum left out
    layer = specs.load_cell("vqvae_cifar10.train_dp4_b2048").layers["psum_ms_per_step.train"]
    every = {k: v for k, v in layer.items() if k != "except"}
    assert specs.reader("psum_ms_per_step.train", every)(view, _info(), every) == pytest.approx(ms(2))


def test_yardstick_kernel_ms_reads_kernels_by_name_with_or_without_spans():
    """A replayed graph's kernels sit under no span: the by-name readers read
    the same there as where the spans are."""
    ms = lambda us: 1e-3 * us / STEPS  # noqa: E731
    bare = view_from_events([e for e in _events() if e["cat"] != "user_annotation" or e["name"] == WINDOW_SPAN])
    for view in (view_from_events(_events()), bare):
        assert _read("search_ms_per_step.train", view) == pytest.approx(ms(2 + 3))     # forward and backward
        assert _read("wgrad_ms_per_step.train", view) == pytest.approx(ms(2))
        assert _read("conv_ms_per_step.train", view) is None       # "conv_kernel" is no cuDNN name
    layer = dict(specs.load_cell("vqvae_cifar10.train_b256").layers["search_ms_per_step.train"],
                 kernels=["_kernel", "Kernel"])
    assert specs.reader("search_ms_per_step.train", layer)(bare, _info(), layer) == pytest.approx(ms(3 + 2 + 2 + 1 + 1))



def test_yardstick_kernel_ms_tells_the_batchs_gather_from_the_searchs():
    """The batch's gather (``train.batch``, int64 rows) and the search's
    gather of z_q (int32 codes) are one kernel template with another index
    type: only the search's is on its list."""
    gather = "void at::native::vectorized_gather_kernel<16, {}>(char*, char*, {}*, int, long)"
    view = view_from_events(_events() + [
        _ev("user_annotation", "search.fma[16x8x4]", 30, 4), _launch(31, 7),
        _ev("kernel", gather.format("int", "int"), 32, 1, tid=0, correlation=7),
        _ev("user_annotation", "train.batch", 95, 3), _launch(95.5, 8),
        _ev("kernel", gather.format("long", "long"), 96, 2, tid=0, correlation=8)])
    ms = lambda us: 1e-3 * us / STEPS  # noqa: E731
    assert _read("search_ms_per_step.train", view) == pytest.approx(ms(2 + 3 + 1))
