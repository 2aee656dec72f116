"""On a card: each per-layer metric read by kernel name (``layers/kernel_ms.py``)
takes in its layer's kernels and no others. Run on the card with
``python -m pytest yardstick/tests/test_yardstick_kernel_names.py -m gpu -s``.

A VQ-VAE update on a card runs eager once for a batch shape and then replays
a CUDA graph, whose kernels sit under no op or span of the program. So the
window's own call (the driver's ``unit``) on a program just built runs one
eager update, in which every kernel sits under the ops and spans that
launched it, and then replays; the batch's gather, the optimizer and, on
several chips, the exchange run eager in every update. For each metric whose
JSON has ``attributed`` (a reader and its arguments that read the same layer
by op and span), over that call:

- every kernel that the names take in was launched by the graph (under
  nothing of the program) or is taken in by ``attributed`` too, so no
  kernel of another layer (the batch's gather, the exchange's copies) has a
  name on the list;
- on the eager update the two readings agree within ``AGREE``;
- the replays read within ``AGREE`` of the eager update by name.

A cell on several chips runs every rank, the exchange between them on.
"""

import multiprocessing
import queue as queue_module
from collections import defaultdict

import pytest

from yardstick import run
from yardstick import spec as specs
from yardstick.tests.conftest import CELLS
from yardstick.trace import WINDOW_SPAN, Tracer, TraceView

AGREE = 0.05
SEED = 3_700_000_001
NAMED = [c for c in CELLS if any("attributed" in layer for layer in specs.load_cell(c).layers.values())]


def _info(steps):
    return run.SliceInfo(steps=steps, items=0, chips=1, sizes={}, flop_per_item=0.0,
                         arithmetic="float32", peaks={}, rows_per_item=None)


def _reading(read, spec, ops, steps):
    return read(TraceView(window_s=0.0, busy_s=0.0, ops=ops), _info(steps), spec)


def _first_call(cell_name, seed, device, rank=0, mesh_cfg=None):
    """The readings of the window's call on a program just built (picklable)."""
    import torch

    cell_spec = specs.load_cell(cell_name)
    cell = cell_spec.driver()(cell_spec, seed, device, rank, mesh_cfg)
    cell.build()
    tracer = Tracer(on_card=True)
    tracer.start()
    torch.ones(1, device=device).add_(1)          # the profiler's own warm-up
    torch.cuda.synchronize(device)
    with torch.profiler.record_function(WINDOW_SPAN):
        steps, _items, losses = cell.unit()
        losses.cpu()
        torch.cuda.synchronize(device)
    tracer.stop()
    view = tracer.view()
    cell.release()

    outer = {WINDOW_SPAN, cell.unit_name}
    eager = [op for op in view.ops if set(op.ancestors) - outer]
    graph = [op for op in view.ops if not set(op.ancestors) - outer]
    report = {"rank": rank, "metrics": {}, "stray": [], "outside": []}
    marks = defaultdict(set)
    for metric, layer in cell_spec.layers.items():
        if "attributed" not in layer:
            continue
        by_name = specs.reader(metric, layer)
        against = dict(layer["attributed"])
        by_op = specs.reader(metric, {"reader": against.pop("reader")})
        for op in eager:
            named = _reading(by_name, layer, [op], 1) is not None
            if named:
                marks[id(op)].add(metric)
            if named and _reading(by_op, against, [op], 1) is None:
                report["stray"].append((metric, op.name[:90], " > ".join(op.ancestors[-3:]), op.dur))
        report["metrics"][metric] = {
            "by_name_eager": _reading(by_name, layer, eager, 1),
            "attributed_eager": _reading(by_op, against, view.ops, 1),
            "by_name_replays": _reading(by_name, layer, graph, steps - 1)}
    # what the program launched outside the update's layers, in every update
    rows = defaultdict(lambda: [0, 0.0, ()])
    for op in eager:
        under = [a for a in op.ancestors if a not in outer]
        if under and not under[0].startswith(("train.forward", "train.backward", "autograd::", "search.")):
            row = rows[(op.name[:90], " > ".join(under[:2]))]
            row[0] += 1
            row[1] += op.dur * 1e-3
            row[2] = tuple(sorted(marks[id(op)]))
    report["outside"] = sorted(((n, u, c, ms, list(m)) for (n, u), (c, ms, m) in rows.items()),
                               key=lambda r: -r[3])
    return report


def _rank(cell_name, seed, rank, world, port, queue):
    from yardstick import program

    mesh_cfg, device = program.bring_up(world, rank, port, "cuda")
    try:
        queue.put(_first_call(cell_name, seed, device, rank, mesh_cfg))
    finally:
        program.shut_down()


def _every_rank(cell_name, world, monkeypatch):
    from yardstick import program

    monkeypatch.setenv("NCCL_SHM_DISABLE", "1")
    program.build_kernels()
    ctx = multiprocessing.get_context("spawn")
    queue, port = ctx.Queue(), run._free_port()
    procs = [ctx.Process(target=_rank, args=(cell_name, SEED, r, world, port, queue)) for r in range(world)]
    for p in procs:
        p.start()
    reports = []
    try:
        while len(reports) < world and not any(p.exitcode for p in procs):
            try:
                reports.append(queue.get(timeout=5))
            except queue_module.Empty:
                pass
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
                p.join()
    assert len(reports) == world and all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return sorted(reports, key=lambda r: r["rank"])


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", NAMED)
def test_yardstick_kernel_names_hold_their_layers_kernels(cell_name, monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with -m gpu")
    chips = specs.load_cell(cell_name).chips
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{cell_name} needs {chips} cards")
    for key in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "CUDA_CACHE_PATH"):
        monkeypatch.setenv(key, "")               # restored after the test
    run.set_cache_dirs()
    if chips == 1:
        reports = [_first_call(cell_name, SEED, torch.device("cuda", 0))]
    else:
        reports = _every_rank(cell_name, chips, monkeypatch)
    for report in reports:
        for metric, r in report["metrics"].items():
            print(f"{cell_name} rank {report['rank']} {metric}: by name {r['by_name_eager']!r}, "
                  f"attributed {r['attributed_eager']!r}, replays {r['by_name_replays']!r}")
        for name, under, count, ms, metrics in report["outside"]:
            print(f"{cell_name} rank {report['rank']} outside the layers: {ms:.5f} ms, {count}x {name} "
                  f"under {under}; on the lists of {metrics or 'none'}")
    for report in reports:
        assert not report["stray"], f"kernels on a name list launched outside the layer: {report['stray'][:10]}"
        for metric, r in report["metrics"].items():
            assert r["by_name_eager"] == pytest.approx(r["attributed_eager"], rel=AGREE), metric
            assert r["by_name_replays"] == pytest.approx(r["by_name_eager"], rel=AGREE), metric
