"""Which hand-written kernel serves a nearest-code call, and how the kernel
library is keyed (vqvae_tpu_torch/ops/cuda_quantizer.py).

Everything here runs without a card and without ``nvcc``: the dispatch is a
pure function of (precision, D), the build digest is a hash of files, and the
wrapper's refusals come before any build. This file imports no JAX.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from vqvae_tpu_torch.ops import cuda_quantizer
from vqvae_tpu_torch.ops.quantizer import nearest_code, nearest_code_torch


def _inputs(n, k, d, seed=0):
    rng = np.random.default_rng(seed)
    return (
        torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)),
        torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32)),
    )


@pytest.mark.parametrize(
    "precision, d, want",
    [
        ("default", 16, "mma"),
        ("default", 48, "mma"),
        ("default", 64, "mma"),
        ("default", 128, "mma"),
        ("high", 48, "mma"),
        ("high", 64, "mma"),
        ("high", 128, "mma"),
        # "highest" is fp32: never on the bf16 tensor-core kernel
        ("highest", 48, "fma"),
        ("highest", 64, "fma"),
        ("highest", 128, "fma"),
        ("highest", 256, "fma"),
        # above the depth the tensor-core kernel holds in registers
        ("default", 256, "fma"),
        ("high", 256, "fma"),
        ("default", 144, "fma"),
        # no multiple of the mma depth step
        ("default", 40, "fma"),
        ("high", 72, "fma"),
        ("default", 8, "fma"),
    ],
)
def test_kernel_route(precision, d, want):
    assert cuda_quantizer.kernel_route(precision, d) == want
    assert cuda_quantizer.resolve_route(None, precision, d) == want
    # the CUDA-core kernel takes everything
    assert cuda_quantizer.resolve_route("fma", precision, d) == "fma"


def test_kernel_route_rejects_unknown_precision():
    with pytest.raises(ValueError, match="precision"):
        cuda_quantizer.kernel_route("fast", 64)


@pytest.mark.parametrize(
    "precision, d", [("highest", 64), ("default", 256), ("high", 40), ("default", 8)]
)
def test_explicit_mma_route_outside_its_envelope_raises(precision, d, monkeypatch):
    """Refused from (precision, D) alone, before any build."""
    monkeypatch.setattr(cuda_quantizer, "build", lambda: pytest.fail("a build was started"))
    with pytest.raises(ValueError, match="mma route"):
        cuda_quantizer.resolve_route("mma", precision, d)


def test_unknown_route_raises():
    with pytest.raises(ValueError, match="route must be"):
        cuda_quantizer.resolve_route("wgmma", "default", 64)


@pytest.mark.parametrize("route", [None, "mma", "fma"])
def test_cpu_tensor_refusal_comes_before_the_route(route, monkeypatch):
    """A CPU tensor is refused first, whatever the route, and nothing is built."""
    monkeypatch.setattr(cuda_quantizer, "build", lambda: pytest.fail("a build was started"))
    z, cb = _inputs(8, 4, 256)  # D = 256 is outside the mma envelope
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_quantizer.nearest_code_indices(z, cb, "default", route)


def test_build_digest_changes_with_any_source_and_with_the_flags(tmp_path):
    """The library is keyed by every file under csrc/ and by the flags."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_quantizer.CSRC, csrc)
    files = sorted(p for p in csrc.rglob("*") if p.is_file())
    assert {p.name for p in files} >= {"nearest_code.cu", "nearest_code_mma.cu"}
    assert cuda_quantizer.sources(csrc) == [p for p in files if p.suffix == ".cu"]
    base = cuda_quantizer.source_digest(csrc)
    assert base == cuda_quantizer.source_digest(cuda_quantizer.CSRC)
    assert base == cuda_quantizer.source_digest(csrc)  # stable
    seen = {base}
    for path in files:
        original = path.read_bytes()
        path.write_bytes(original + b"\n// touched\n")
        changed = cuda_quantizer.source_digest(csrc)
        assert changed not in seen, f"{path.name} is not in the digest"
        seen.add(changed)
        path.write_bytes(original)
        assert cuda_quantizer.source_digest(csrc) == base
    (csrc / "extra.cuh").write_text("// a new header\n")
    assert cuda_quantizer.source_digest(csrc) not in seen
    assert cuda_quantizer.source_digest(cuda_quantizer.CSRC, ("-O0",)) != base


@pytest.mark.parametrize(
    "k, d, precision, want",
    [
        (512, 64, "default", 4 * 512 + 2 * 512 * 64),
        (512, 64, "high", 4 * 512 + 2 * 2 * 512 * 64),
        # ||e||^2 is padded to four values, so the bf16 codebook behind it starts
        # on 16 bytes, where the search kernel's 16-byte copies need it
        (301, 64, "default", 4 * 304 + 2 * 301 * 64),
        (301, 48, "high", 4 * 304 + 2 * 2 * 301 * 48),
        (1, 16, "default", 4 * 4 + 2 * 16),
    ],
)
def test_mma_scratch_bytes(k, d, precision, want):
    assert cuda_quantizer.mma_scratch_bytes(k, d, precision) == want
    assert (want - 2 * k * d * (2 if precision == "high" else 1)) % 16 == 0


def test_cpu_path_moves_no_launch_count():
    z, cb = _inputs(40, 24, 64, seed=3)
    before = (cuda_quantizer.launches, dict(cuda_quantizer.launches_by_route))
    for precision in ("highest", "high", "default"):
        zq, idx = nearest_code(z, cb, precision)
        _, idx_ref = nearest_code_torch(z, cb, precision)
        assert torch.equal(idx, idx_ref)
    assert (cuda_quantizer.launches, dict(cuda_quantizer.launches_by_route)) == before


def test_reset_launch_counts(monkeypatch):
    monkeypatch.setattr(cuda_quantizer, "launches", 5)
    monkeypatch.setitem(cuda_quantizer.launches_by_route, "mma", 3)
    monkeypatch.setitem(cuda_quantizer.launches_by_route, "fma", 2)
    cuda_quantizer.reset_launch_counts()
    assert cuda_quantizer.launches == 0
    assert cuda_quantizer.launches_by_route == {"mma": 0, "fma": 0}
