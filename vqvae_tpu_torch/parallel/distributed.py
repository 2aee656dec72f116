"""Bringing up ``torch.distributed`` (port of ``vqvae_tpu/parallel/distributed.py``).

The JAX package calls ``jax.distributed.initialize`` and then sees every
device of every host in one mesh. The port runs one process a rank and one
device a rank: ``maybe_initialize_distributed`` joins this process to the
group of all ranks and picks its device, and ``parallel/mesh.py`` lays the
ranks out as the (data x code) mesh. Nothing happens unless
``MeshConfig.distributed`` is set, so one process runs the same code alone.

    python -m vqvae_tpu_torch.cli train-vqvae --distributed \\
        --coordinator_address 10.0.0.1:29500 --num_processes 4 --process_id 0 ...

or under a launcher that sets ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` (``torchrun --nproc_per_node 4
-m vqvae_tpu_torch.cli train-vqvae --distributed ...``), which the
``env://`` rendezvous reads where the flags are not given.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from vqvae_tpu_torch.config import MeshConfig
from vqvae_tpu_torch.device import resolve_device

# A rank that dies leaves the others waiting; this bounds the rendezvous and
# (with gloo) every collective.
TIMEOUT = datetime.timedelta(minutes=5)
BACKENDS = ("nccl", "gloo")


def rank_device(cfg: MeshConfig, device: str | torch.device = "cuda") -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK or process_id or RANK) % device_count``
    for a distributed CUDA run, else ``device`` as it is (a missing card raises)."""
    dev = resolve_device(device)
    if not cfg.distributed or dev.type != "cuda" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        local = cfg.process_id if cfg.process_id is not None else os.environ.get("RANK", 0)
    return torch.device("cuda", int(local) % torch.cuda.device_count())


def maybe_initialize_distributed(cfg: MeshConfig, device: str | torch.device = "cuda") -> torch.device:
    """Join the group of all ranks when ``cfg.distributed``; return this rank's device.

    The rendezvous is ``tcp://<coordinator_address>`` with ``num_processes``
    ranks and rank ``process_id``; where those are None, the launcher's
    ``env://`` variables. The backend is ``cfg.backend``, by default NCCL on
    a CUDA device and gloo on the CPU (the JAX package's CPU rule,
    ``vqvae_tpu/parallel/distributed.py:31-35``). A failed NCCL start raises;
    nothing gives way to gloo.
    """
    dev = rank_device(cfg, device)
    if not cfg.distributed:
        return dev
    backend = cfg.backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs CUDA ranks; use gloo on the CPU")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_method = f"tcp://{cfg.coordinator_address}" if cfg.coordinator_address else "env://"
    kwargs = {}
    if cfg.num_processes is not None:
        kwargs["world_size"] = cfg.num_processes
    if cfg.process_id is not None:
        kwargs["rank"] = cfg.process_id
    dist.init_process_group(backend, init_method=init_method, timeout=TIMEOUT, **kwargs)
    return dev


def is_primary_host() -> bool:
    """Rank 0, or a process that joined no group: the one that prints and writes."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown_distributed() -> None:
    """Leave the group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


__all__ = [
    "TIMEOUT",
    "is_primary_host",
    "maybe_initialize_distributed",
    "rank_device",
    "shutdown_distributed",
]
