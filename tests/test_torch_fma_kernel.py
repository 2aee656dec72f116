"""The CUDA-core nearest-code kernel's tile and shared memory, as the wrapper
reckons them (vqvae_tpu_torch/ops/cuda_quantizer.py::fma_smem_bytes against
vqvae_tpu_torch/csrc/nearest_code.cu).

Everything here runs without a card and without ``nvcc``: the wrapper's
constants are held against the ``constexpr`` values and macro defaults parsed
from the source, and the reckoning against the hardware's limit. The kernel
walks the depth in chunks and keeps z in shared memory only where it fits, so
no depth is refused. This file imports no JAX.
"""

from __future__ import annotations

import re

import pytest

from vqvae_tpu_torch.ops import cuda_quantizer

SOURCE = (cuda_quantizer.CSRC / "nearest_code.cu").read_text()
MODES = ["highest", "high", "default"]


def _macro_default(name: str) -> int:
    found = re.search(rf"#ifndef {name}\n#define {name} (\d+)\n#endif", SOURCE)
    assert found, f"{name} has no default in nearest_code.cu"
    return int(found.group(1))


def _constexpr(name: str) -> str:
    found = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE)
    assert found, f"{name} is not a constexpr int of nearest_code.cu"
    return found.group(1).strip()


def test_python_tile_constants_equal_the_source():
    assert _constexpr("kBlockRows") == "VQ_BLOCK_ROWS"
    assert _constexpr("kDepthChunk") == "VQ_DEPTH_CHUNK"
    assert cuda_quantizer.FMA_BLOCK_ROWS == _macro_default("VQ_BLOCK_ROWS")
    assert cuda_quantizer.FMA_DEPTH_CHUNK == _macro_default("VQ_DEPTH_CHUNK")
    assert cuda_quantizer.FMA_TILE_CODES == int(_constexpr("kTileCodes"))
    assert cuda_quantizer.MAX_SMEM_BYTES == int(_constexpr("kMaxSmemBytes"))
    # the layout the reckoning mirrors: unpadded depth-major lines, planes, slots
    assert _constexpr("kLdZ") == "kBlockRows"
    assert _constexpr("kLdE") == "kTileCodes"
    assert _constexpr("kPlanes") == "MODE == kHigh ? 2 : 1"
    assert _constexpr("kZSlot") == "kPlanes * kZFloats"
    assert _constexpr("kESlot") == "kPlanes * kEFloats"
    assert "return 4 * (z_slots * kZSlot + 2 * kESlot + 2 * kTileCodes);" in SOURCE
    assert "chunks <= (kMaxSmemBytes - L::bytes(0)) / (4 * L::kZSlot)" in SOURCE
    assert "L::bytes(resident ? chunks : 2)" in SOURCE


# one chunk of 128 rows x 32 depths is 16 KB a plane; the code slots and ||e||^2
# take 33 KB ("high": 65 KB)
FIXED = {"highest": 33_792, "default": 33_792, "high": 66_560}
SLOT = {"highest": 16_384, "default": 16_384, "high": 32_768}


@pytest.mark.parametrize("precision", MODES)
@pytest.mark.parametrize("d, chunks", [(45, 2), (48, 2), (64, 2), (256, 8), (452, 15)])
def test_fma_smem_bytes(d, chunks, precision):
    """Depths the main path and the tests use, up to the deepest the earlier
    kernel took (452): z resident where its chunks fit, two slots in turn where
    they do not, and never more than a block may have."""
    resident = FIXED[precision] + chunks * SLOT[precision] <= cuda_quantizer.MAX_SMEM_BYTES
    want = FIXED[precision] + (chunks if resident else 2) * SLOT[precision]
    assert cuda_quantizer.fma_smem_bytes(d, precision) == want
    # above 48 KB, so the launcher raises the dynamic-shared-memory attribute
    assert 48 * 1024 < want <= cuda_quantizer.MAX_SMEM_BYTES


@pytest.mark.parametrize(
    "precision, last_resident", [("highest", 384), ("default", 384), ("high", 160)]
)
def test_first_depth_that_streams_z(precision, last_resident):
    """No depth raises; past the resident envelope z is staged chunk by chunk
    and the shared memory falls back to two z slots."""
    resident = FIXED[precision] + last_resident // 32 * SLOT[precision]
    assert cuda_quantizer.fma_smem_bytes(last_resident, precision) == resident
    assert resident <= cuda_quantizer.MAX_SMEM_BYTES < resident + SLOT[precision]
    streaming = FIXED[precision] + 2 * SLOT[precision]
    for d in (last_resident + 1, 452, 1024, 4096, 2**20):
        assert cuda_quantizer.fma_smem_bytes(d, precision) == streaming


def test_fma_smem_bytes_rejects_bad_arguments():
    with pytest.raises(ValueError, match="precision"):
        cuda_quantizer.fma_smem_bytes(64, "fast")
    with pytest.raises(ValueError, match="depth"):
        cuda_quantizer.fma_smem_bytes(0, "highest")


@pytest.mark.parametrize("precision", MODES)
@pytest.mark.parametrize("d", [1, 45, 48, 64, 256, 452, 453, 1024, 4096])
def test_fma_route_takes_every_depth(precision, d):
    """Depths that fit the earlier kernel (up to 452) and depths beyond."""
    assert cuda_quantizer.resolve_route("fma", precision, d) == "fma"
    assert cuda_quantizer.fma_smem_bytes(d, precision) <= cuda_quantizer.MAX_SMEM_BYTES


def test_library_interface_has_no_depth_query():
    """The depth envelope is reckoned in Python; the library exports the two
    searches, the empty kernel, the error string and (since the weight-gradient
    kernel joined the library) ``vq_conv_wgrad``."""
    exported = set()
    for path in cuda_quantizer.sources():
        text = path.read_text()
        extern_c = text[text.index('extern "C"'):]
        exported |= set(re.findall(r"^\w[\w\s\*]*?\b(vq_\w+)\(", extern_c, flags=re.M))
    assert exported == {"vq_nearest_code", "vq_nearest_code_mma", "vq_empty_kernel",
                        "vq_error_string", "vq_conv_wgrad"}


def test_sweep_ablations_apply_to_the_shipped_source(tmp_path, monkeypatch):
    """``sweep_nearest_code.py ablate`` times copies of the source with parts
    taken out by text replacement: every replacement must still match the
    shipped source exactly once, and each copy must differ from it."""
    root = cuda_quantizer.CSRC.parents[1]
    monkeypatch.syspath_prepend(str(root))
    import sweep_nearest_code

    jobs = sweep_nearest_code.ablated_sources(str(tmp_path))
    assert set(jobs) == set(sweep_nearest_code.ABLATIONS) and "shipped" in jobs
    texts = {name: open(path).read() for name, (path, _defines) in jobs.items()}
    assert texts["shipped"] == SOURCE
    for name, text in texts.items():
        assert (text == SOURCE) == (name == "shipped"), name
