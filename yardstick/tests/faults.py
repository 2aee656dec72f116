"""Faults planted under the timed path, for the tests that see ``correct``
come out false: an update that leaves the state unchanged, half of each
batch left out (the mean over the rest), the gradient exchange between
ranks left out, and a code altered where the search produces it."""

import multiprocessing

import torch

from yardstick import run

_RANK_MAIN = run.rank_main
FAULTS = ("unchanged", "half_batch", "no_exchange", "altered_answer")


def _no_step(self, closure=None):
    return None


def plant(fault, set_attr=setattr):
    from vqvae_tpu_torch.ops import quantizer
    from vqvae_tpu_torch.train import optim
    from vqvae_tpu_torch.train.pixelcnn_train import PixelCNNTrainer
    from vqvae_tpu_torch.train.vqvae_train import VQVAETrainer

    if fault == "unchanged":
        set_attr(optim.TorchAmsgrad, "step", _no_step)
        set_attr(optim.Adam, "step", _no_step)
    elif fault == "half_batch":
        vq, prior = VQVAETrainer._update, PixelCNNTrainer._update
        set_attr(VQVAETrainer, "_update", lambda self, state, x: vq(self, state, x[: max(1, len(x) // 2)]))
        set_attr(PixelCNNTrainer, "_update", lambda self, state, x, label: prior(
            self, state, x[: max(1, len(x) // 2)], label[: max(1, len(x) // 2)]))
    elif fault == "no_exchange":
        set_attr(VQVAETrainer, "_reduce_gradients", lambda self, model: None)
    elif fault == "altered_answer":
        search = quantizer._search_forward

        def altered(z_flat, codebook, precision, impl):
            _z_q, idx = search(z_flat, codebook, precision, impl)
            idx = idx.clone()
            idx[0] = (idx[0] + 1) % codebook.shape[0]
            return codebook.index_select(0, idx), idx

        set_attr(quantizer, "_search_forward", altered)
    else:
        raise ValueError(fault)


def rank_main_with(fault, *args, **kwargs):
    """``run.rank_main`` with ``fault`` planted in a spawned rank (the test
    plants it in its own process, where rank 0 runs)."""
    if multiprocessing.parent_process() is not None:
        torch.set_num_threads(1)
        plant(fault)
    return _RANK_MAIN(*args, **kwargs)
