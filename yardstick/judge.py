"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``yardstick/reference/``), each number beside
the limit that the cell's file states.

Training (``training``): the reference follows the program's first three
updates from the same weights on the same rows, and three numbers are
compared:

- ``loss_gap``: the largest relative gap between the program's loss and the
  reference's over the three updates;
- ``grad_gap``: by the worst leaf, the gap between the norms of the first
  gradient as the program's optimizer got it and as the reference computed
  it, over the reference's norm of that leaf or of the median leaf,
  whichever is larger;
- ``change_gap``: the same for the norm of each leaf's change over the
  three updates. Leaves whose reference gradient is under a thousandth of
  the median leaf's move by round-off alone under Adam and are left out.

Extraction (``extraction``): every code of the last pass, against the
reference's encoder (float32, TF32 off): ``code_gap`` is the largest excess
of the chosen code's squared distance over the least, computed in float64
from the reference's latent, over ||z||^2 + max ||e||^2; and
``passes_differing`` counts the window's passes whose codes differ from the
last's anywhere (limit 0).
"""

from __future__ import annotations

import math
import statistics
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from yardstick.reference import optim
from yardstick.reference.precision import fp32


def reference_steps(loss_fn: Callable, params0: Dict[str, torch.Tensor], batches: Sequence,
                    lr: float, optimizer: Tuple[str, float, float, float], mode: str = "ieee",
                    grad_rows: Optional[Callable] = None):
    """The reference's updates from ``params0`` on ``batches``: (losses,
    first gradient by leaf, parameters after the last update).
    ``optimizer`` is (kind, b1, b2, eps) of ``reference/optim.py``.
    ``grad_rows`` (a fault planted in the reference put in the program's
    place) maps a batch to the rows whose loss gives the gradient."""
    params = {n: p.detach().clone().requires_grad_(True) for n, p in params0.items()}
    state = optim.init_state(params)
    losses, first = [], None
    with fp32(mode):
        for batch in batches:
            loss = loss_fn(params, batch)
            grad_loss = loss if grad_rows is None else loss_fn(params, grad_rows(batch))
            grads = torch.autograd.grad(grad_loss, list(params.values()), allow_unused=True)
            grads = dict(zip(params, grads))
            if first is None:
                first = {n: (g.detach().clone() if g is not None else torch.zeros_like(params[n]))
                         for n, g in grads.items()}
            optim.step(optimizer[0], {n: p.data for n, p in params.items()}, grads, state, lr,
                       *optimizer[1:])
            losses.append(float(loss.detach()))
    return losses, first, {n: p.detach() for n, p in params.items()}


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in tree.items()}


def training(prog_losses: Sequence[float], prog_grad: Dict[str, torch.Tensor],
             prog_params: Dict[str, torch.Tensor], ref_losses: Sequence[float],
             ref_grad: Dict[str, torch.Tensor], ref_params: Dict[str, torch.Tensor],
             params0: Dict[str, torch.Tensor]) -> Tuple[Dict[str, float], List[str]]:
    """The three numbers, and the leaves left out of ``change_gap``."""
    loss_gap = max(abs(p - r) / abs(r) if math.isfinite(p) else math.inf
                   for p, r in zip(prog_losses, ref_losses))
    gp, gr = _norms(prog_grad), _norms(ref_grad)
    med_g = statistics.median(gr.values())
    grad_gaps = [abs(gp[n] - gr[n]) / max(gr[n], med_g) for n in gr]
    dp = _norms({n: prog_params[n].double() - params0[n].double() for n in params0})
    dr = _norms({n: ref_params[n].double() - params0[n].double() for n in params0})
    counted = [n for n in dr if gr[n] >= 1e-3 * med_g]
    med_d = statistics.median(dr[n] for n in counted)
    change_gaps = [abs(dp[n] - dr[n]) / max(dr[n], med_d) for n in counted]
    numbers = {"loss_gap": loss_gap, "grad_gap": max(grad_gaps), "change_gap": max(change_gaps),
               "grad_gap_median": statistics.median(grad_gaps),
               "change_gap_median": statistics.median(change_gaps)}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in numbers.items()}, \
        [n for n in dr if n not in counted]


@torch.no_grad()
def extraction(passes: List[np.ndarray], data: np.ndarray, encode: Callable,
               codebook: torch.Tensor, block: int, device,
               gap_limit: float) -> Tuple[Dict[str, float], int]:
    """The two numbers, and the images of the window found wrong: each image
    of a pass that differs from the last, and in the others each image with
    a code beyond ``gap_limit`` (every image where the answers are missing)."""
    n = len(data)
    last = passes[-1]
    rows = codebook.shape[0]
    if last.shape[0] != n:
        return {"code_gap": math.inf, "passes_differing": float(len(passes))}, n * len(passes)
    differing = sum(1 for p in passes if p.shape != last.shape or not np.array_equal(p, last))
    cb = codebook.double()
    e_sq = (cb * cb).sum(1)
    worst, bad = 0.0, 0
    for s in range(0, n, block):
        x = torch.from_numpy(np.ascontiguousarray(data[s:s + block])).to(device)
        with fp32("ieee"):
            z = encode(x)
        z = z.reshape(-1, z.shape[-1]).double()
        scores = e_sq[None, :] - 2.0 * (z @ cb.T)
        picked = torch.from_numpy(np.ascontiguousarray(last[s:s + block])).to(device).reshape(-1).long()
        if picked.numel() != z.shape[0] or bool(((picked < 0) | (picked >= rows)).any()):
            return {"code_gap": math.inf, "passes_differing": float(differing)}, n * len(passes)
        gap = scores.gather(1, picked[:, None])[:, 0] - scores.min(1).values
        scale = (z * z).sum(1) + e_sq.max()
        rel = (gap / scale).reshape(x.shape[0], -1).max(1).values
        worst = max(worst, float(rel.max()))
        bad += int((rel > gap_limit).sum())
    failed = differing * n + bad * (len(passes) - differing)
    return {"code_gap": worst, "passes_differing": float(differing)}, failed


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
