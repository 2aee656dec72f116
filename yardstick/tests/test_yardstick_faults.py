"""A whole run, the look for a card skipped, with the timed path broken
underneath: ``correct`` has to come out false for every fault that a cell
can have (``faults.py``)."""

import functools
import json

import pytest

from yardstick.tests import faults

CASES = [
    ("vqvae_cifar10.train_b256", "unchanged"),
    ("vqvae_cifar10.train_b256", "half_batch"),
    ("gated_pixelcnn_cifar10.train_b1024", "unchanged"),
    ("gated_pixelcnn_cifar10.train_b1024", "half_batch"),
    ("vqvae_cifar10.train_dp4_b2048", "unchanged"),
    ("vqvae_cifar10.train_dp4_b2048", "half_batch"),
    ("vqvae_cifar10.train_dp4_b2048", "no_exchange"),
    ("vqvae_cifar10.extract_b4096", "altered_answer"),
]


@pytest.mark.parametrize("name,fault", CASES)
def test_yardstick_fault_is_not_correct(cardless, capsys, monkeypatch, name, fault):
    run = cardless
    assert run.main(["--workload", name, "--seed", "77", "--seconds", "0.3"]) == 0
    sound = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sound["correct"] is True
    faults.plant(fault, monkeypatch.setattr)
    monkeypatch.setattr(run, "rank_main", functools.partial(faults.rank_main_with, fault))
    assert run.main(["--workload", name, "--seed", "77", "--seconds", "0.3"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"] for c in line["checks"].values())
