"""Which hand-written kernel serves a nearest-code call, and how the kernel
library is keyed (vqvae_tpu_torch/ops/cuda_quantizer.py).

Everything here runs without a card and without ``nvcc``: the dispatch is a
pure function of (precision, D), the build digest is a hash of files, the
tensor-core kernel's shared memory is reckoned in Python from the constants
of its source, and the wrapper's refusals come before any build. This file
imports no JAX.
"""

from __future__ import annotations

import re
import shutil
import sys

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
        # the rows of z sit in shared memory, so the depth runs to 256
        ("default", 144, "mma"),
        ("high", 144, "mma"),
        ("default", 256, "mma"),
        ("high", 256, "mma"),
        # "highest" is fp32: never on the bf16 tensor-core kernel
        ("highest", 48, "fma"),
        ("highest", 64, "fma"),
        ("highest", 128, "fma"),
        ("highest", 256, "fma"),
        # above the deepest layout that fits in shared memory
        ("default", 272, "fma"),
        ("high", 272, "fma"),
        ("default", 512, "fma"),
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
    "precision, d", [("highest", 64), ("default", 272), ("high", 40), ("default", 8)]
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
    z, cb = _inputs(8, 4, 272)  # D = 272 is outside the mma envelope
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_quantizer.nearest_code_indices(z, cb, "default", route)


def test_build_digest_changes_with_any_source_and_with_the_flags(tmp_path):
    """The library is keyed by every file under csrc/ and by the flags."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_quantizer.CSRC, csrc)
    files = sorted(p for p in csrc.rglob("*") if p.is_file())
    assert {p.name for p in files} >= {"nearest_code.cu", "nearest_code_mma.cu",
                                       "nearest_code_mma_sync.cu"}
    # the library builds the top level only; the baseline under variants/ is
    # the measuring script's
    assert cuda_quantizer.sources(csrc) == [p for p in files if p.suffix == ".cu" and p.parent == csrc]
    assert all(p.parent == csrc for p in cuda_quantizer.sources(csrc))
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
    "d, precision, want",
    [
        # z: 128 rows x ceil(D / 64) atoms x 128 bytes a plane; three code tiles
        # of 64 codes (planes x atoms x 64 x 128); two fp32 stages of 64 x D x 4;
        # ||e||^2 of three tiles; two mbarriers; 1,024 bytes of alignment slack
        (64, "default", 16_384 + 24_576 + 32_768 + 768 + 16 + 1024),
        (64, "high", 32_768 + 49_152 + 32_768 + 768 + 16 + 1024),
        (16, "default", 16_384 + 24_576 + 8_192 + 768 + 16 + 1024),
        (48, "high", 32_768 + 49_152 + 24_576 + 768 + 16 + 1024),
        (128, "high", 65_536 + 98_304 + 65_536 + 768 + 16 + 1024),
        (144, "default", 49_152 + 73_728 + 73_728 + 768 + 16 + 1024),
        # D = 256 takes 32-code tiles ("default") and 16-code tiles ("high"):
        # the layout shrinks the code tile, not the envelope
        (256, "default", 65_536 + 49_152 + 65_536 + 384 + 16 + 1024),
        (256, "high", 131_072 + 49_152 + 32_768 + 192 + 16 + 1024),
    ],
)
def test_mma_smem_bytes(d, precision, want):
    assert cuda_quantizer.mma_smem_bytes(d, precision) == want


@pytest.mark.parametrize("precision", ["default", "high"])
@pytest.mark.parametrize("d", range(16, 257, 16))
def test_every_mma_depth_fits_in_shared_memory(d, precision):
    """Every depth of the envelope has a layout under the 227 KB a block may
    use, with the widest code tile that fits, and its base starts aligned."""
    nbytes = cuda_quantizer.mma_smem_bytes(d, precision)
    codes = cuda_quantizer.mma_tile_codes(d, precision)
    assert nbytes <= cuda_quantizer.MAX_SMEM_BYTES
    assert codes in (16, 32, 64)
    if codes < 64:  # the next wider tile would not fit
        planes = 2 if precision == "high" else 1
        assert cuda_quantizer._mma_layout_bytes(d, planes, 2 * codes) > cuda_quantizer.MAX_SMEM_BYTES


@pytest.mark.parametrize("precision, d", [("highest", 64), ("default", 272), ("high", 40)])
def test_mma_smem_bytes_only_inside_the_envelope(precision, d):
    with pytest.raises(ValueError, match="mma"):
        cuda_quantizer.mma_smem_bytes(d, precision)


def test_mma_layout_constants_follow_the_source():
    """The Python figure mirrors nearest_code_mma.cu: its shipped block shape,
    ring depths, alignment and shared-memory limit."""
    text = (cuda_quantizer.CSRC / "nearest_code_mma.cu").read_text()

    def constant(pattern):
        return int(re.search(pattern, text).group(1))

    assert constant(r"#define VQ_WARPGROUPS (\d+)") == cuda_quantizer.MMA_WARPGROUPS
    assert constant(r"#define VQ_RAW_STAGES (\d+)") == cuda_quantizer.MMA_RAW_STAGES
    assert constant(r"constexpr int kTileStages = (\d+);") == cuda_quantizer.MMA_TILE_STAGES
    assert constant(r"constexpr int kAtomAlign = (\d+);") == cuda_quantizer.MMA_ATOM_ALIGN
    assert constant(r"constexpr int kMaxSmemBytes = (\d+);") == cuda_quantizer.MAX_SMEM_BYTES
    assert constant(r"constexpr int kMaxDepthSteps = (\d+);") * 16 == cuda_quantizer.MMA_MAX_D
    assert "prepare_codebook" not in text and "void* scratch" not in text  # one kernel, no scratch


def test_sweep_mma_ablations_apply_to_the_shipped_source(tmp_path, monkeypatch):
    """``sweep_nearest_code.py mma_ablate`` times copies of the tensor-core
    source with parts taken out: every replacement must match the shipped
    source exactly once, and each copy must differ from it."""
    monkeypatch.syspath_prepend(str(cuda_quantizer.CSRC.parents[1]))
    monkeypatch.delitem(sys.modules, "sweep_nearest_code", raising=False)
    import sweep_nearest_code

    shipped = (cuda_quantizer.CSRC / "nearest_code_mma.cu").read_text()
    jobs = sweep_nearest_code.ablated_sources(str(tmp_path), "nearest_code_mma.cu",
                                              sweep_nearest_code.MMA_ABLATIONS)
    assert set(jobs) == set(sweep_nearest_code.MMA_ABLATIONS)
    for name, (path, _defines) in jobs.items():
        assert (open(path).read() == shipped) == (name == "shipped"), name
    assert sweep_nearest_code.BASELINE.is_file()


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
