"""Model configuration (PyTorch port of ``vqvae_tpu/config.py``).

The port keeps its own copy of ``VQVAEConfig`` with the same fields and
defaults, so hyperparameter dicts stored in checkpoints round-trip between
the two packages unchanged, and of ``TrainConfig``. Defaults are the
reference's (main.py:16-30), of ``PixelCNNConfig`` and of ``MeshConfig``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional


class _DictMixin:
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


QUANTIZER_IMPLS = ("auto", "pallas", "jnp")


def check_quantizer_impl(impl: str) -> None:
    if impl not in QUANTIZER_IMPLS:
        raise ValueError(f"quantizer_impl must be one of {', '.join(QUANTIZER_IMPLS)}, got {impl!r}")


@dataclass(frozen=True)
class VQVAEConfig(_DictMixin):
    """VQ-VAE model hyperparameters (reference defaults: main.py:16-25)."""

    in_channels: int = 3
    n_hiddens: int = 128            # h_dim
    n_residual_hiddens: int = 32    # res_h_dim
    n_residual_layers: int = 2
    embedding_dim: int = 64
    n_embeddings: int = 512
    beta: float = 0.25
    # The reference aliases one ResidualLayer across the whole stack
    # (reference models/residual.py:44-45); True reproduces that weight
    # sharing, False (default) gives each layer its own weights.
    share_residual_weights: bool = False
    # Conv-stack compute dtype ("float32" or "bfloat16"); params stay fp32.
    compute_dtype: str = "float32"
    # fp32 conv arithmetic: "highest" turns cuDNN's TF32 off (full fp32, the
    # reference's training arithmetic); "high" and "default" allow TF32.
    # Irrelevant when compute_dtype="bfloat16".
    conv_precision: str = "highest"
    # The nearest-code search's forward (ops/quantizer.py): on the card
    # "pallas" launches the hand-written kernel, "jnp" takes the matmul
    # branch (cuBLAS + argmin) and "auto" the one measured faster at the
    # shape (_auto_impl); a CPU tensor takes the plain version.
    quantizer_impl: str = "auto"
    # Distance arithmetic in the quantizer: "highest" (fp32), "high" (bf16x3
    # split product), "default" (bf16 operands, fp32 accumulation; near-tie
    # code assignments may flip).
    quantizer_precision: str = "highest"
    # EMA codebook (van den Oord et al. 2017, appendix A.1): the loss is the
    # beta-weighted commitment term only, and the trainer overwrites the
    # codebook from running assignment counts and sums after every update
    # (train/vqvae_train.py).
    ema_codebook: bool = False
    ema_decay: float = 0.99
    ema_epsilon: float = 1e-5

    def __post_init__(self):
        check_quantizer_impl(self.quantizer_impl)


@dataclass(frozen=True)
class PixelCNNConfig(_DictMixin):
    """GatedPixelCNN prior hyperparameters (reference pixelcnn/gated_pixelcnn.py:27-42,69)."""

    input_dim: int = 512            # number of discrete codes (n_embeddings)
    dim: int = 64                   # the reference sets dim = img_dim**2 = 64
    n_layers: int = 15
    n_classes: int = 10
    img_dim: int = 8                # latent grid side
    # Conv-stack compute dtype of the full forward ("float32" or "bfloat16");
    # params stay fp32 and logits come out fp32. The cached sampler always
    # computes in fp32.
    compute_dtype: str = "float32"
    # fp32 conv and matmul arithmetic, as VQVAEConfig.conv_precision.
    conv_precision: str = "highest"


@dataclass(frozen=True)
class TrainConfig(_DictMixin):
    """Training-loop hyperparameters (reference defaults: main.py:16-30).

    The same fields and defaults as the JAX package's ``TrainConfig``, so the
    hyperparameter dicts stored in checkpoints round-trip.
    """

    batch_size: int = 32
    n_updates: int = 5000
    learning_rate: float = 3e-4     # Adam(amsgrad) -- main.py:55
    # AMSGrad flavour. "torch" is the reference's optimizer: torch-1.1.0
    # semantics (raw second-moment max, current-step bias correction),
    # written by hand in train/optim.py. "optax" names the JAX package's
    # comparison variant; the port does not have it and raises on it.
    amsgrad_impl: str = "torch"
    log_interval: int = 50
    dataset: str = "CIFAR10"
    seed: int = 0
    save: bool = False
    filename: Optional[str] = None
    data_dir: str = "data"
    results_dir: str = "results"
    # Prior-loop extras (reference pixelcnn/gated_pixelcnn.py:27-42)
    epochs: int = 100
    gen_samples: bool = False
    # Updates run per chunk. The per-step metrics stay on the device inside
    # a chunk and cross to the host once at its end; 1 reads them back after
    # every update, as the reference does. The update order is the same.
    steps_per_dispatch: int = 1
    # With chunks of more than one update: keep the whole training set on
    # the device and gather each batch there from an uploaded index array,
    # when the set fits under device_data_max_bytes.
    device_data: bool = True
    device_data_max_bytes: int = 2_000_000_000


@dataclass(frozen=True)
class MeshConfig(_DictMixin):
    """Data and codebook parallelism (``parallel/``): one process a rank, one
    device a rank, ``n_data x n_code`` ranks.

    The batch is split over ``data``; the conv weights are replicated; with
    ``n_code > 1`` the (K, D) codebook, its optimizer moments and the EMA
    statistics are row-sharded over ``code``. The fields are the JAX
    package's, plus ``backend``.
    """

    # The JAX package names its mesh axes here; the port's process groups
    # are always "data" and "code", and these two fields exist only so that
    # a JAX MeshConfig's dict loads. Another name is refused.
    data_axis: str = "data"
    # None => world size // n_code.
    n_data: Optional[int] = None
    code_axis: str = "code"
    n_code: int = 1
    # torch.distributed.init_process_group: off by default. Where the three
    # below are None, a launcher's env:// variables (MASTER_ADDR,
    # MASTER_PORT, WORLD_SIZE, RANK) are read instead.
    distributed: bool = False
    coordinator_address: Optional[str] = None   # "host:port"
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    # Collective backend. None: "nccl" when the rank's device is CUDA, else
    # "gloo". "gloo" on CUDA ranks where several share one card, which NCCL
    # refuses.
    backend: Optional[str] = None

    def __post_init__(self):
        if (self.data_axis, self.code_axis) != ("data", "code"):
            raise ValueError(f"the port's mesh axes are 'data' and 'code', got "
                             f"{self.data_axis!r} and {self.code_axis!r}")


__all__ = ["MeshConfig", "PixelCNNConfig", "QUANTIZER_IMPLS", "VQVAEConfig", "TrainConfig",
           "check_quantizer_impl"]
