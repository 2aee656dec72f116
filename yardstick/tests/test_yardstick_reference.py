"""The plain references against the port at a small size on the CPU: the
same seeded weights and inputs give the same forward, loss, gradients and
codes to float32 rounding."""

import numpy as np
import pytest
import torch

from yardstick import inputs
from yardstick.drivers.extract import ExtractCell
from yardstick.drivers.train import TrainCell
from yardstick.reference import gated_pixelcnn, vqvae
from yardstick.tests.conftest import small_cell


@pytest.mark.parametrize("name", ["vqvae_cifar10.train_b256", "gated_pixelcnn_cifar10.train_b1024"])
def test_yardstick_reference_follows_the_ports_first_updates(name):
    cell = TrainCell(small_cell(name), 2**33 + 5, "cpu")
    cell.setup()
    cell.release()
    numbers = cell.numbers()
    assert numbers["loss_gap"] < 1e-6 and numbers["grad_gap"] < 1e-5 and numbers["change_gap"] < 1e-3


def test_yardstick_prior_reference_logits_equal_the_ports():
    from vqvae_tpu_torch.config import PixelCNNConfig
    from vqvae_tpu_torch.models.pixelcnn import GatedPixelCNN

    cfg = small_cell("gated_pixelcnn_cifar10.train_b1024").config
    params = inputs.weights(gated_pixelcnn.param_specs(cfg), 11, "cpu")
    model = GatedPixelCNN(PixelCNNConfig.from_dict(cfg))
    model.load_state_dict(params, strict=True)
    codes, labels = inputs.code_grids(6, cfg["img_dim"], cfg["input_dim"], cfg["n_classes"], 12, "cpu")
    with torch.no_grad():
        ours = gated_pixelcnn.logits(params, codes.long(), labels.long(), cfg).permute(0, 2, 3, 1)
        theirs = model(codes, labels)
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-5)


def test_yardstick_vqvae_reference_codes_equal_the_ports():
    cell = ExtractCell(small_cell("vqvae_cifar10.extract_b4096"), 13, "cpu")
    cell.setup()
    cell.unit()
    assert np.array_equal(cell.passes[-1], cell.reference_codes("ieee"))
    numbers, failed = cell.numbers(gap_limit=1e-7)
    assert numbers == {"code_gap": 0.0, "passes_differing": 0.0} and failed == 0


def test_yardstick_vqvae_reference_weights_load_into_the_port():
    from vqvae_tpu_torch.config import VQVAEConfig
    from vqvae_tpu_torch.models.vqvae import VQVAE

    cfg = small_cell("vqvae_cifar10.train_b256").config
    params = inputs.weights(vqvae.param_specs(cfg), 3, "cpu")
    model = VQVAE(VQVAEConfig.from_dict(cfg))
    model.load_state_dict(params, strict=True)
    x, _ = inputs.images(4, 3, "cpu")
    with torch.no_grad():
        torch.testing.assert_close(vqvae.encode(params, x, cfg), model.encode(x), rtol=1e-5, atol=1e-5)
