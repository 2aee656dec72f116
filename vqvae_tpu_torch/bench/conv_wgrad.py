"""The hand-written weight-gradient kernel (``csrc/conv_wgrad.cu``) at the
training convolutions of both models, on one CUDA card.

    python -m vqvae_tpu_torch.bench.conv_wgrad [check] [times] [sweep] [ablate] [--out PATH]

(``check`` and ``times`` when none is named; ``chip_smoke.py`` runs both.)
Every row is one JSON line; ``--out`` also writes them to a file.

``VQVAE_CONVS`` and ``PRIOR_CONVS`` are the models' training convolutions
at their published widths, each at the batches of the benchmark's cells
(``VQVAE_BATCHES``: 256 on one card, 512 a rank in dp4; ``PRIOR_BATCH``).

``check``: at every convolution, the kernel on random fp32 operands against
the plain version (``ops/conv.py::plain_wgrad``) in float64: every element
within 2**-24 * (k_slice + S + 2) * the float64 sum of |a| |b| over its
terms (the bound of a recursive fp32 sum of the slice's terms, then of the
S partials); two calls bit for bit equal, and a third while a second stream
keeps the card busy, so that the blocks finish in another order. The
prior's vert_to_horiz reads b through the view of the cropped vertical
pre-activation, as the prior hands it over.

``times``: each convolution's kernel time (``timing.time_ms``, CUDA events
over 50 calls queued behind a spin), the plain version's on the card in
fp32 (``plain_ms``, at the host's pace: ``F.unfold`` launches a kernel an
image), its bound (the larger of 2 M N K over the fp32 peak
and a, b and dW moved once over HBM's bandwidth), and cuDNN's deterministic
fp32 weight gradient with TF32 off (``aten.convolution_backward`` asking
for the weight only: the ``library_ms``, what the port called before and
never calls now); then the sums an update of each model at each batch,
weighted by each convolution's count.

``sweep``: the tiles and splits around ``conv_wgrad.plan``'s choice at each
convolution (every tile, S halved and doubled, one group and sqrt(S)
groups), launched through the library with a workspace of their own and
timed in turns with the plan; each must give the plan's dW within twice the
check's bound.

``ablate``: where the kernel's time goes. Copies of the source with one part
of the work taken out (``ABLATIONS``: text replacements, each of which must
match exactly once), each compiled into a library of its own, timed in turns
at ``ABLATION_CONVS``. The copies return wrong gradients; only their times
are read.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

from vqvae_tpu_torch.bench.timing import check as require
from vqvae_tpu_torch.bench.timing import device_line, time_ms
from vqvae_tpu_torch.ops import conv_wgrad, cuda_quantizer
from vqvae_tpu_torch.ops.conv import conv_fp32_precision, plain_wgrad
from vqvae_tpu_torch.utils.flops import H100_SXM

# name -> (x's (C, H, W), w's shape, stride, padding, transposed, keep, count
# an update). The VQ-VAE's encoder, residual stacks, pre-quantization and
# decoder; the prior's 15 gated layers (mask A at layer 0) and its head on
# 8 x 8 grids, its stacks cropped to the grid after the convolution.
VQVAE_CONVS = {
    "enc.conv1": ((3, 32, 32), (64, 3, 4, 4), 2, 1, False, (None, None), 1),
    "enc.conv2": ((64, 16, 16), (128, 64, 4, 4), 2, 1, False, (None, None), 1),
    "enc.conv3": ((128, 8, 8), (128, 128, 3, 3), 1, 1, False, (None, None), 1),
    "res.conv3x3": ((128, 8, 8), (32, 128, 3, 3), 1, 1, False, (None, None), 4),
    "res.conv1x1": ((32, 8, 8), (128, 32, 1, 1), 1, 0, False, (None, None), 4),
    "pre_quant": ((128, 8, 8), (64, 128, 1, 1), 1, 0, False, (None, None), 1),
    "dec.convt1": ((64, 8, 8), (64, 128, 3, 3), 1, 1, True, (None, None), 1),
    "dec.convt2": ((128, 8, 8), (128, 64, 4, 4), 2, 1, True, (None, None), 1),
    "dec.convt3": ((64, 16, 16), (64, 3, 4, 4), 2, 1, True, (None, None), 1),
}
PRIOR_CONVS = {
    "vert.A": ((64, 8, 8), (128, 64, 4, 7), 1, (3, 3), False, (8, None), 1),
    "vert.B": ((64, 8, 8), (128, 64, 2, 3), 1, (1, 1), False, (8, None), 14),
    "horiz.A": ((64, 8, 8), (128, 64, 1, 4), 1, (0, 3), False, (None, 8), 1),
    "horiz.B": ((64, 8, 8), (128, 64, 1, 2), 1, (0, 1), False, (None, 8), 14),
    "vert_to_horiz": ((128, 8, 8), (128, 128, 1, 1), 1, 0, False, (None, None), 15),
    "horiz_resid": ((64, 8, 8), (64, 64, 1, 1), 1, 0, False, (None, None), 15),
    "out1": ((64, 8, 8), (512, 64, 1, 1), 1, 0, False, (None, None), 1),
    "out2": ((512, 8, 8), (512, 512, 1, 1), 1, 0, False, (None, None), 1),
}
VQVAE_BATCHES = (256, 512)
PRIOR_BATCH = 1024

SOURCE = cuda_quantizer.CSRC / "conv_wgrad.cu"
ABLATIONS = {
    "shipped": [],
    # only the ring's first stages are filled; the barrier and the product stay
    "staging_out": [("    if (chunk + kStages - 1 < chunks) stage(",
                     "    if (false && chunk + kStages - 1 < chunks) stage(")],
    # 8 FMAs a depth instead of 64; every operand is still read
    "fmas_out": [("          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);\n",
                  "          if (i == j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);\n")],
    # every block writes its tile to dW: no partial tiles, no sums of them
    "split_sum_out": [("  if (g.slices == 1) {\n", "  if (true) {\n")],
    # one block an SM, up to 255 registers a thread
    "one_block_an_sm": [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")],
}
ABLATION_CONVS = ("vqvae.enc.conv2", "vqvae.res.conv3x3", "prior.vert.B", "prior.vert_to_horiz")


def shapes(spec, batch: int):
    """The shapes of (a, b) that a training convolution hands the kernel, and
    its output's: a is dy and b is x; transposed, a is x and b is dy."""
    (c, h, w), w_shape, stride, padding, transposed = spec[:5]
    kh, kw = w_shape[2:]
    (sh, sw), (ph, pw) = conv_wgrad.pair(stride), conv_wgrad.pair(padding)
    if transposed:
        out = (batch, w_shape[1], (h - 1) * sh - 2 * ph + kh, (w - 1) * sw - 2 * pw + kw)
        return (batch, c, h, w), out, out
    out = (batch, w_shape[0], (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1)
    return out, (batch, c, h, w), out


def gemm_shape(spec, batch: int):
    """(M, N, K) of the kernel's product for a training convolution."""
    a, b, _out = shapes(spec, batch)
    keep, w_shape = spec[5], spec[1]
    p = a[2] if keep[0] is None else min(a[2], keep[0])
    q = a[3] if keep[1] is None else min(a[3], keep[1])
    return a[1], b[1] * w_shape[2] * w_shape[3], batch * p * q


def cases():
    """(name, spec, batch) of every convolution at every batch of its cells."""
    for name, spec in VQVAE_CONVS.items():
        for batch in VQVAE_BATCHES:
            yield f"vqvae.{name}", spec, batch
    for name, spec in PRIOR_CONVS.items():
        yield f"prior.{name}", spec, PRIOR_BATCH


def operands(name, spec, batch, gen):
    """(a, b) on the card as a training step hands them over: dy zero outside
    the kept part, vert_to_horiz's b a view."""
    a_shape, b_shape, _out = shapes(spec, batch)
    a = torch.randn(a_shape, generator=gen, device="cuda")
    rows, cols = spec[5]
    if (rows, cols) != (None, None) and not spec[4]:
        mask = torch.zeros_like(a)
        mask[:, :, :rows, :cols] = 1
        a = a * mask
    if name == "prior.vert_to_horiz":
        b = torch.randn((batch, 128, 8 + 3, 8), generator=gen, device="cuda")[:, :, :8]
    else:
        b = torch.randn(b_shape, generator=gen, device="cuda")
    return a, b


def kernel(a, b, spec):
    w_shape, stride, padding, keep = spec[1], spec[2], spec[3], spec[5]
    return conv_wgrad.weight_grad(a, b, w_shape[2], w_shape[3], stride, padding, keep)


def plain(a, b, spec):
    w_shape, stride, padding, keep = spec[1], spec[2], spec[3], spec[5]
    return plain_wgrad(a, b, w_shape[2], w_shape[3], stride, padding, keep)


def bound(a, b, spec, pl):
    """2**-24 (k_slice + S + 2) sum |a||b| over each element's terms (float64)."""
    return 2.0 ** -24 * (pl.k_slice + pl.slices + 2) * plain(a.abs().double(), b.abs().double(), spec)


def check(seed: int = 0) -> list:
    """The check's rows, each with ``ok``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    side = torch.cuda.Stream()
    rows = []
    for name, spec, batch in cases():
        a, b = operands(name, spec, batch, gen)
        pl = conv_wgrad.plan(*gemm_shape(spec, batch))
        got = kernel(a, b, spec)
        want = plain(a.double(), b.double(), spec)
        err = (got.double() - want).abs()
        lim = bound(a, b, spec, pl)
        again = kernel(a, b, spec)
        big = torch.randn(8192, 8192, device="cuda")
        with torch.cuda.stream(side):  # another stream keeps SMs busy while the kernel runs
            for _ in range(3):
                big = big @ big.t() * 1e-4
        busy = kernel(a, b, spec)
        torch.cuda.synchronize()
        row = {"part": "check", "conv": name, "batch": batch, "mnk": list(gemm_shape(spec, batch)),
               "plan": pl._asdict(), "max_err": float(err.max()),
               "max_ratio": float((err / lim.clamp_min(1e-30)).max()),
               "rel_err": float(err.max() / want.abs().max()),
               "same_twice": bool(torch.equal(got, again)), "same_busy": bool(torch.equal(got, busy))}
        row["ok"] = row["max_ratio"] <= 1.0 and row["same_twice"] and row["same_busy"]
        rows.append(row)
    return rows


def cudnn_wgrad(a, b, spec):
    """cuDNN's deterministic weight gradient alone, fp32, TF32 off under the
    caller's ``conv_fp32_precision("highest")``."""
    w_shape, stride, padding, transposed = spec[1], spec[2], spec[3], spec[4]
    x, dy = (a, b) if transposed else (b, a)
    w = torch.empty(w_shape, device="cuda")
    st, pd = conv_wgrad.pair(stride), conv_wgrad.pair(padding)
    return lambda: torch.ops.aten.convolution_backward(
        dy, x, w, None, st, pd, (1, 1), transposed, (0, 0), 1, (False, True, False))


def bound_ms(a, b, spec, batch):
    """(ms, what binds it) on an H100 SXM: 2 M N K at the fp32 peak, or a's
    kept part, b and dW moved once."""
    m, n, k = gemm_shape(spec, batch)
    t_ops = 2.0 * m * n * k / H100_SXM.peak_fp32_flops
    t_bytes = 4.0 * (m * k + b.numel() + m * n) / H100_SXM.hbm_bytes_per_sec
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def times(seed: int = 1) -> list:
    """A row a convolution, then a row an update of each model at each batch."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows, totals = [], {}
    with conv_fp32_precision("highest"):
        for name, spec, batch in cases():
            a, b = operands(name, spec, batch, gen)
            b_ms, b_by = bound_ms(a, b, spec, batch)
            row = {"part": "times", "conv": name, "batch": batch, "mnk": list(gemm_shape(spec, batch)),
                   "plan": conv_wgrad.plan(*gemm_shape(spec, batch))._asdict(),
                   "kernel_ms": time_ms(lambda: kernel(a, b, spec)),
                   # unfold launches a kernel an image, more than the launch
                   # queue holds behind a spin: the plain version at the host's pace
                   "plain_ms": time_ms(lambda: plain(a, b, spec), iters=5, warmup=2, queue_ahead=False),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": time_ms(cudnn_wgrad(a, b, spec), iters=20), "count": spec[6]}
            row["share_of_bound"] = b_ms / row["kernel_ms"]
            rows.append(row)
            t = totals.setdefault(f"{name.split('.')[0]}@{batch}",
                                  {"kernel_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0})
            for key in t:
                t[key] += spec[6] * row[key]
    for key, t in totals.items():
        rows.append({"part": "times", "update": key, **t, "share_of_bound": t["bound_ms"] / t["kernel_ms"]})
    return rows


def launcher(lib, a, b, spec, pl=None):
    """One call of ``lib``'s kernel on (a, b) under the plan ``pl`` (the
    wrapper's own when None), with a workspace of its own: a function that
    launches it and returns dW."""
    w_shape, stride, padding, keep = spec[1], spec[2], spec[3], spec[5]
    g, base, shape, _ws = conv_wgrad.geometry(a.shape, a.stride(), b.shape, b.stride(), w_shape[2],
                                              w_shape[3], stride, padding, keep)
    pl = pl or base
    g = type(g).from_buffer_copy(g)
    g.k_slice, g.slices, g.group_size, g.groups = pl.k_slice, pl.slices, pl.group_size, pl.groups
    floats, counters = conv_wgrad.workspace_floats(pl, g.m, g.n)
    part = torch.empty(max(floats, 1), device=a.device)
    cnt = torch.zeros(max(counters, 1), dtype=torch.int32, device=a.device)
    dw = torch.empty(shape, device=a.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.vq_conv_wgrad(a.data_ptr(), b.data_ptr(), dw.data_ptr(), part.data_ptr(), cnt.data_ptr(),
                                ctypes.addressof(g), pl.bm, pl.bn, stream)
        require(err == 0, f"conv_wgrad launch failed: {err}")
        return dw
    return run


def alternatives(m, n, k):
    base = conv_wgrad.plan(m, n, k)
    chunks = -(-k // conv_wgrad.CHUNK)
    seen = {base}
    for bm, bn in conv_wgrad.TILES:
        tiles = -(-m // bm) * -(-n // bn)
        if tiles * bm * bn > 4 * max(m * n, 4096):
            continue
        full = conv_wgrad.SMS * conv_wgrad.blocks_per_sm(bm, bn) // tiles
        for s in sorted({max(1, full // 2), max(1, full), max(1, 2 * full), max(1, base.slices)}):
            s = min(s, chunks)
            per = -(-chunks // s)
            s = -(-chunks // per)
            for group in sorted({s, max(1, math.isqrt(s - 1) + 1) if s > 1 else 1}):
                pl = conv_wgrad.Plan(bm, bn, s, per * conv_wgrad.CHUNK, group, -(-s // group))
                if pl not in seen:
                    seen.add(pl)
                    yield pl


def sweep(seed: int = 2) -> list:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lib, rows = conv_wgrad.library(), []
    for name, spec, batch in cases():
        if batch == 512:
            continue
        a, b = operands(name, spec, batch, gen)
        m, n, k = gemm_shape(spec, batch)
        base = conv_wgrad.plan(m, n, k)
        ref = kernel(a, b, spec).double()
        lim = bound(a, b, spec, base) * 2
        plan_ms = [time_ms(lambda: kernel(a, b, spec), iters=30)]
        found = []
        for pl in alternatives(m, n, k):
            run = launcher(lib, a, b, spec, pl)
            ok = bool(((run().double() - ref).abs() <= lim).all())
            found.append((pl, time_ms(run, iters=30), ok))
        plan_ms.append(time_ms(lambda: kernel(a, b, spec), iters=30))
        best = min(found, key=lambda r: r[1]) if found else None
        rows.append({"part": "sweep", "conv": name, "batch": batch, "mnk": [m, n, k], "plan": list(base),
                     "plan_ms": plan_ms, "best": list(best[0]) if best else None,
                     "best_ms": best[1] if best else None,
                     "all": [[list(pl), round(ms, 5), ok] for pl, ms, ok in sorted(found, key=lambda r: r[1])]})
    return rows


def ablate(seed: int = 5) -> list:
    text = SOURCE.read_text()
    libs, rows = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, edits in ABLATIONS.items():
            src = text
            for old, new in edits:
                require(src.count(old) == 1, f"ablation {name}: {old!r} matches {src.count(old)} times")
                src = src.replace(old, new)
            path = os.path.join(tmp, f"{name}.cu")
            with open(path, "w") as f:
                f.write(src)
            out = os.path.join(tmp, f"lib{name}.so")
            procs[name] = (out, subprocess.Popen(
                [cuda_quantizer.nvcc_path(), *cuda_quantizer.NVCC_FLAGS, "-shared", "-o", out, path],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (out, proc) in procs.items():
            log = proc.communicate()[0]
            require(proc.returncode == 0, f"ablation {name}: nvcc failed\n{log}")
            lib = ctypes.CDLL(out)
            lib.vq_conv_wgrad.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            lib.vq_conv_wgrad.restype = ctypes.c_int
            libs[name] = lib
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for name, spec, batch in cases():
            if name not in ABLATION_CONVS or batch == 512:
                continue
            a, b = operands(name, spec, batch, gen)
            runs = {n: launcher(lib, a, b, spec) for n, lib in libs.items()}
            turns = {n: [] for n in libs}
            for n in list(libs) + list(libs)[::-1]:
                turns[n].append(time_ms(runs[n], iters=30))
            rows.append({"part": "ablate", "conv": name, "batch": batch,
                         "plan": list(conv_wgrad.plan(*gemm_shape(spec, batch))),
                         "ms": {n: round(min(t), 5) for n, t in turns.items()}})
    return rows


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    out = None
    if "--out" in argv:
        at = argv.index("--out")
        out = argv[at + 1]
        del argv[at:at + 2]
    parts = argv or ["check", "times"]
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    print(device_line(torch.device("cuda")), flush=True)
    t0 = time.perf_counter()
    conv_wgrad.library()
    lines = cuda_quantizer.build_log.splitlines()
    for i, line in enumerate(lines):  # each conv_wgrad kernel's entry and its report
        if "conv_wgrad_kernel" in line and "Compiling" in line:
            print("\n".join(lines[i:i + 4]), flush=True)
    print(f"build and load {time.perf_counter() - t0:.1f} s", flush=True)
    rows = []
    for part in parts:
        for row in {"check": check, "times": times, "sweep": sweep, "ablate": ablate}[part]():
            print(json.dumps(row), flush=True)
            rows.append(row)
    if out:
        with open(out, "w") as f:
            f.writelines(json.dumps(row) + "\n" for row in rows)
    bad = [row["conv"] for row in rows if row.get("ok") is False]
    print(json.dumps({"ok": not bad, "failed": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
