"""The benchmark's contact with the program under test, the port
``vqvae_tpu_torch``, where it does not depend on the model: joining and
leaving the ranks' process group, and building the port's kernels. What
builds the model's trainer is in the model's file (``models/``).
"""

from __future__ import annotations


def bring_up(n_data: int, rank: int, port: int, device):
    """Join the program's process group the way ``train-vqvae --distributed``
    does (``parallel/distributed.py``); returns the MeshConfig and the
    rank's device."""
    from vqvae_tpu_torch.config import MeshConfig
    from vqvae_tpu_torch.parallel.distributed import maybe_initialize_distributed

    mesh_cfg = MeshConfig(n_data=n_data, n_code=1, distributed=True,
                          coordinator_address=f"localhost:{port}", num_processes=n_data,
                          process_id=rank)
    return mesh_cfg, maybe_initialize_distributed(mesh_cfg, device)


def shut_down():
    from vqvae_tpu_torch.parallel.distributed import shutdown_distributed

    shutdown_distributed()


def build_kernels():
    """Build the port's nvcc library once, before any rank needs it."""
    from vqvae_tpu_torch.ops import cuda_quantizer

    cuda_quantizer.build()
