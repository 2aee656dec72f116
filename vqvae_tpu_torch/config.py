"""Model configuration (PyTorch port of ``vqvae_tpu/config.py``).

The port keeps its own copy of ``VQVAEConfig`` with the same fields and
defaults, so hyperparameter dicts stored in checkpoints round-trip between
the two packages unchanged, and of ``TrainConfig``. Defaults are the
reference's (main.py:16-30), and of ``PixelCNNConfig``. The mesh config comes
with the slice that uses it.
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
    # Kept so hyperparameter dicts round-trip with the JAX package. The port
    # does not dispatch on it: a CUDA tensor always goes through the
    # hand-written kernel, a CPU tensor through the plain version.
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


__all__ = ["PixelCNNConfig", "VQVAEConfig", "TrainConfig"]
