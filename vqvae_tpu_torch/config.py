"""Model configuration (PyTorch port of ``vqvae_tpu/config.py``).

The port keeps its own copy of ``VQVAEConfig`` with the same fields and
defaults, so hyperparameter dicts stored in checkpoints round-trip between
the two packages unchanged. Defaults are the reference's (main.py:16-25).
The prior, training and mesh configs come with the slices that use them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict


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
    # beta-weighted commitment term only. The EMA update itself belongs to
    # the training slice.
    ema_codebook: bool = False
    ema_decay: float = 0.99
    ema_epsilon: float = 1e-5


__all__ = ["VQVAEConfig"]
