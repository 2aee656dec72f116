"""The measured dispatch of ``quantizer_impl="auto"`` and the matmul branch it
may choose (``vqvae_tpu_torch/ops/quantizer.py``), held against the JAX
package's ``_auto_impl`` and ``_nearest_code_fwd_jnp`` and against the
committed sweep ``artifacts_torch/autotune_h100.json``.

Inputs come from seeded numpy and go to both frameworks. XLA on the CPU
computes an fp32 product whatever the precision asks for, so JAX's
``_nearest_code_fwd_jnp`` does the mode's arithmetic on the CPU only where
the operands are already bf16 values (then the bf16 rounding and the hi/lo
split change nothing): in "high" and "default" it is held to the branch on
such inputs, and the interpreted Pallas kernel, which rounds as the mode
asks, is the oracle on general ones. Index tolerance: the near-tie rule
(``compare_assignments``, rel_tol 1e-5); gathered rows are the codebook's
own bits.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.ops.pallas_quantizer import nearest_code_pallas
from vqvae_tpu.ops.quantizer import _auto_impl as jax_auto_impl
from vqvae_tpu.ops.quantizer import _nearest_code_fwd_jnp
from vqvae_tpu_torch.bench import quantizer as quantizer_bench
from vqvae_tpu_torch.ops import quantizer
from vqvae_tpu_torch.ops.quantizer import compare_assignments, nearest_code_matmul, nearest_code_torch

MODES = ["highest", "high", "default"]
SWEEP = Path(__file__).resolve().parents[1] / "artifacts_torch" / "autotune_h100.json"
# the shapes of the JAX package's test of its rule (tests/test_quantizer.py)
JAX_RULE_SHAPES = [(2048, 8192, 256), (2048, 512, 64), (2048, 2048, 64), (2048, 2048, 128),
                   (2048, 4096, 128), (65536, 8192, 256), (1 << 20, 1 << 20, 64)]


def _inputs(n, k, d, seed=0, bf16_exact=False):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, d)).astype(np.float32)
    cb = rng.standard_normal((k, d)).astype(np.float32)
    if bf16_exact:
        z, cb = (torch.from_numpy(a).bfloat16().float().numpy() for a in (z, cb))
    return z, cb


def _sweep_rows():
    return json.loads(SWEEP.read_text())["rows"]


@pytest.mark.parametrize("precision", MODES)
@pytest.mark.parametrize("shape", JAX_RULE_SHAPES)
def test_off_the_card_the_rule_is_jnp_as_in_jax(shape, precision):
    """Off the card the rule answers "jnp", as JAX's does off the TPU."""
    assert quantizer._auto_impl(*shape, precision, on_card=False) == "jnp"
    assert jax_auto_impl(*shape, precision, on_tpu=False) == "jnp"


@pytest.mark.parametrize("precision", MODES)
def test_scores_over_the_budget_go_to_the_kernel(precision):
    """Scores the branch would materialise beyond the budget: the kernel,
    in every mode, as in JAX's rule; at the budget itself the rule decides."""
    assert quantizer._auto_impl(1 << 20, 1 << 20, 64, precision, on_card=True) == "pallas"
    n = quantizer._SCORES_BUDGET_BYTES // (4 * 8192)
    assert 4 * n * 8192 == quantizer._SCORES_BUDGET_BYTES
    assert quantizer._auto_impl(n + 1, 8192, 64, precision, on_card=True) == "pallas"


def test_the_sweep_covers_the_grid_once():
    rows = _sweep_rows()
    keys = sorted((tuple(r["shape"]), r["precision"]) for r in rows)
    want = sorted(((n, k, d), mode) for n in quantizer_bench.GRID_N for k in quantizer_bench.GRID_K
                  for d in quantizer_bench.GRID_D for mode in MODES)
    assert keys == want
    head = json.loads(SWEEP.read_text())
    assert list(head)[0] == "device" and "H100" in head["device"] and "W" in head["device"]
    assert head["margin"] == quantizer_bench.MARGIN


@pytest.mark.parametrize("precision", MODES)
@pytest.mark.parametrize("n", quantizer_bench.GRID_N)
def test_the_rule_picks_the_sweeps_winner(n, precision):
    """At every swept row the rule picks the route the sweep found faster
    beyond the margin and the spread between turns, and the kernel at every
    tie; each row's recorded winner is ``verdict`` of its own turns."""
    rows = [r for r in _sweep_rows() if r["shape"][0] == n and r["precision"] == precision]
    assert len(rows) == len(quantizer_bench.GRID_K) * len(quantizer_bench.GRID_D)
    for r in rows:
        won = quantizer_bench.verdict(r["turns"]["kernel"], r["turns"]["matmul"])
        assert r["winner"] == won, r["shape"]
        assert quantizer._auto_impl(*r["shape"], precision, on_card=True) == won, (r["shape"], r)


@pytest.mark.parametrize("precision", MODES)
def test_every_swept_route_agreed_with_the_plain_version_on_the_card(precision):
    for r in _sweep_rows():
        if r["precision"] == precision:
            for route in ("kernel", "matmul"):
                got = r["vs_plain"][route]
                assert got["mismatches"] == got["near_ties"], (r["shape"], route, got)


@pytest.mark.parametrize(("turns_k", "turns_m", "want"), [
    ((1.0, 1.02), (0.5, 0.51), "jnp"),      # wins by half, beyond the spread
    ((1.0, 1.02), (0.95, 0.96), "pallas"),  # wins by 5%: under the margin
    ((1.0, 1.5), (0.7, 0.71), "pallas"),    # wins by 30%, inside a 0.5 spread
    ((1.0, 1.0), (1.2, 1.2), "pallas"),     # loses
])
def test_verdict(turns_k, turns_m, want):
    assert quantizer_bench.verdict(turns_k, turns_m) == want


@pytest.mark.parametrize("precision", MODES)
@pytest.mark.parametrize("shape", [(200, 300, 48), (256, 512, 64), (64, 37, 8)])
def test_matmul_branch_vs_jax_fwd_jnp(shape, precision):
    """The branch against JAX's ``_nearest_code_fwd_jnp`` on bf16-exact inputs,
    where XLA on the CPU computes every mode's arithmetic."""
    z, cb = _inputs(*shape, bf16_exact=True)
    zq, idx = nearest_code_matmul(torch.from_numpy(z), torch.from_numpy(cb), precision)
    _zq_j, idx_j = _nearest_code_fwd_jnp(jnp.asarray(z), jnp.asarray(cb), precision)
    mism, near, gap = compare_assignments(torch.from_numpy(z), torch.from_numpy(cb), idx,
                                          torch.from_numpy(np.array(idx_j)), precision)
    assert idx.dtype == torch.int32 and idx.shape == (shape[0],)
    assert mism == near, f"{mism - near} of {mism} mismatches are not near-ties (gap {gap})"
    assert np.array_equal(zq.numpy(), cb[idx.numpy()])


@pytest.mark.parametrize("precision", MODES)
@pytest.mark.parametrize("shape", [(200, 300, 48), (256, 512, 64)])
def test_matmul_branch_vs_the_modes_jax_arithmetic(shape, precision):
    """On general inputs: "highest" against ``_nearest_code_fwd_jnp``, "high"
    and "default" against the interpreted Pallas kernel (the mode's
    rounding), and every mode against the port's plain version."""
    z, cb = _inputs(*shape, seed=3)
    zq, idx = nearest_code_matmul(torch.from_numpy(z), torch.from_numpy(cb), precision)
    if precision == "highest":
        _zq_j, idx_j = _nearest_code_fwd_jnp(jnp.asarray(z), jnp.asarray(cb), precision)
    else:
        _zq_j, idx_j = nearest_code_pallas(jnp.asarray(z), jnp.asarray(cb), interpret=True,
                                           precision=precision)
    _zq_p, idx_p = nearest_code_torch(torch.from_numpy(z), torch.from_numpy(cb), precision)
    for other in (torch.from_numpy(np.array(idx_j)), idx_p):
        mism, near, gap = compare_assignments(torch.from_numpy(z), torch.from_numpy(cb), idx, other,
                                              precision)
        assert mism == near, f"{mism - near} of {mism} mismatches are not near-ties (gap {gap})"
    assert np.array_equal(zq.numpy(), cb[idx.numpy()])


@pytest.mark.parametrize("precision", MODES)
def test_matmul_branch_follows_the_kernels_nan_rule(precision):
    """A NaN codebook row is never chosen (each row gets the nearest other
    code); a row of z with NaN, whose scores are all NaN, gets code 0; the
    plain version keeps ``torch.argmin``'s first NaN."""
    z, cb = (torch.from_numpy(a) for a in _inputs(300, 200, 32, seed=4))
    z[7], cb[150] = float("nan"), float("nan")
    _zq, idx = nearest_code_matmul(z, cb, precision)
    keep, finite = torch.arange(200) != 150, torch.arange(300) != 7
    _zq, rest = nearest_code_torch(z, cb[keep], precision)
    want = rest + (rest >= 150).int()
    assert int((idx == 150).sum()) == 0 and int(idx[7]) == 0
    mism, near, _gap = compare_assignments(z[finite], cb.nan_to_num(0.0), idx[finite], want[finite],
                                           precision)
    assert mism == near
    _zq, idx_plain = nearest_code_torch(z, cb, precision)
    assert bool((idx_plain[finite] == 150).all()) and int(idx_plain[7]) == 0


@pytest.mark.parametrize("precision", MODES)
def test_matmul_branch_keeps_infinite_scores(precision):
    """An infinite score stays infinite (``nan_to_num_`` would make it the
    largest finite float): a row whose scores are NaN, +inf, NaN gets code 0,
    as in a kernel, which never takes a score that is not below +inf."""
    z = torch.tensor([[float("inf"), 0.0], [0.0, 1.0]])
    cb = torch.tensor([[float("nan"), 0.0], [-1.0, 0.0], [0.0, 1.0]])
    _zq, idx = nearest_code_matmul(z, cb, precision)
    assert idx.tolist() == [0, 2]


@pytest.mark.parametrize("precision", MODES)
def test_matmul_branch_scopes_tf32_to_its_product(precision, monkeypatch):
    """TF32 is allowed for the product where its operands are bf16 values
    ("high", "default") and off for "highest", inside the precision scope's
    lock, and the caller's setting is back after the call."""
    seen = []
    addmm = torch.addmm

    def spy(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.fp32_precision)
        return addmm(*args, **kwargs)

    monkeypatch.setattr(torch, "addmm", spy)
    before = torch.backends.cuda.matmul.fp32_precision
    z, cb = (torch.from_numpy(a) for a in _inputs(16, 8, 4, seed=5))
    nearest_code_matmul(z, cb, precision)
    assert seen == ["ieee" if precision == "highest" else "tf32"]
    assert torch.backends.cuda.matmul.fp32_precision == before


def test_matmul_branch_refuses_an_unknown_mode():
    z, cb = (torch.from_numpy(a) for a in _inputs(4, 3, 2))
    with pytest.raises(ValueError, match="precision"):
        nearest_code_matmul(z, cb, "fast")
