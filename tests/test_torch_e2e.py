"""The port's counterpart of ``tools/run_e2e_r5.sh`` (``vqvae_tpu_torch/bench/e2e.py``):
the four stages on the CPU at a small width, a failing stage stopping the run,
the report's pre-registered rules (one passing and one failing case a row),
and ``prior-control``'s extraction of a JAX-written EMA checkpoint held
against the JAX package's ``extract-latents`` under the near-tie rule."""

from __future__ import annotations

import json
import math
import os

import numpy as np
import pytest
import torch

from vqvae_tpu.config import TrainConfig as JaxTrainConfig
from vqvae_tpu.config import VQVAEConfig as JaxConfig
from vqvae_tpu.data.datasets import load_dataset as jax_load_dataset
from vqvae_tpu.pipelines.extract import extract_latents as jax_extract_latents
from vqvae_tpu.train.checkpoint import save_checkpoint
from vqvae_tpu.train.vqvae_train import VQVAETrainer
from vqvae_tpu_torch.bench import e2e
from vqvae_tpu_torch.ops.quantizer import compare_assignments
from vqvae_tpu_torch.pipelines.viz import load_model
from vqvae_tpu_torch.train.checkpoint import latest_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_VQVAE = ("--n_hiddens", "16", "--n_residual_hiddens", "8", "--n_embeddings", "16",
               "--embedding_dim", "16", "--log_interval", "5")
SMALL_PRIOR = ("--n_layers", "2")
JAX_HISTORY = json.load(open(os.path.join(e2e.JAX_E2E, "prior_history.json")))["val_loss"]


def test_run_on_the_cpu_through_all_four_stages(tmp_path):
    data_dir = os.path.join(ROOT, "data")
    had_data = os.path.exists(data_dir) and sorted(os.listdir(data_dir))
    out = str(tmp_path / "run")
    assert e2e.run(out, device="cpu", n_updates=6, epochs=2, n_samples=10,
                   model_flags=SMALL_VQVAE, prior_flags=SMALL_PRIOR) == 0
    wall = json.load(open(os.path.join(out, "wall_times.json")))
    for key in ("train_vqvae_5k_s", "extract_latents_s", "train_prior_100ep_s", "sample_10x10_s", "total_s"):
        assert wall[key] > 0
    assert wall["exit_codes"] == {name: 0 for name in e2e.WALL_KEYS}
    assert wall["device"] == "cpu" and wall["torch"] == torch.__version__
    assert wall["launches"] == {name: {"mma": 0, "fma": 0} for name in e2e.WALL_KEYS}  # the CPU runs no kernel
    assert wall["checkpoint"] == "vqvae_e2e_r5_step5.npz" and len(wall["prior_epoch_s"]) == 1
    assert wall["scale"] == {"n_updates": 6, "epochs": 2, "n_samples": 10}
    assert all(os.path.exists(os.path.join(out, name)) for name in e2e.RECORDS)
    with open(os.path.join(out, e2e.METRICS_FILE)) as f:
        assert [json.loads(line)["step"] for line in f] == list(range(6))
    hist = json.load(open(os.path.join(out, "codes_histogram.json")))
    assert len(hist["counts"]) == 16 and sum(hist["counts"]) == 12000 * 64
    assert hist["live_codes"] == sum(c > 0 for c in hist["counts"])
    prior = json.load(open(os.path.join(out, "prior_history.json")))
    assert len(prior["train_loss"]) == len(prior["val_loss"]) == 1 and np.isfinite(prior["val_loss"]).all()
    with np.load(os.path.join(out, "samples_codes.npz")) as d:
        assert d["codes"].shape == (10, 8, 8) and d["codes"].max() < 16
        assert np.array_equal(d["labels"], np.arange(10) % 10)
        assert bool(d["images_finite"]) and tuple(d["images_shape"]) == (10, 32, 32, 3)
    # the stages' logs are what the stages printed, the kernel launches last
    assert "Saved (12000, 64) code grids" in open(os.path.join(out, "extract_latents.log")).read()
    assert open(os.path.join(out, "sample.log")).read().splitlines()[-1].startswith(e2e.LAUNCHES_TAG)

    payload = e2e.report(out, json_out=str(tmp_path / "report.json"))
    assert [r["rule"] for r in payload["run"]["rows"]] == [
        "vqvae_recon", "vqvae_perplexity", "live_codes", "prior_best", "prior_overfit", "sampling"]
    assert all(isinstance(r["pass"], bool) for r in payload["run"]["rows"])
    assert json.load(open(tmp_path / "report.json"))["all_pass"] == payload["all_pass"] is False
    dst = tmp_path / "records"
    assert e2e.copy_records(out, str(dst)) == list(e2e.RECORDS)
    assert sorted(os.listdir(dst)) == sorted(e2e.RECORDS)
    # nothing was written into the repository's data/
    assert (os.path.exists(data_dir) and sorted(os.listdir(data_dir))) == had_data


def test_a_failing_stage_stops_the_run(tmp_path):
    out = str(tmp_path / "run")
    rc = e2e.run(out, device="cpu", n_updates=2, model_flags=("--no_such_flag",))
    assert rc == 2  # argparse's exit code, as the stage gave it
    wall = json.load(open(os.path.join(out, "wall_times.json")))
    assert wall["exit_codes"] == {"train_vqvae": 2} and "total_s" not in wall
    assert not os.path.exists(os.path.join(out, "extract_latents.log"))


def test_the_run_and_the_report_refuse_the_jax_records(tmp_path):
    with pytest.raises(ValueError, match="artifacts"):
        e2e.run(os.path.join(ROOT, "artifacts", "e2e_port"), device="cpu")
    with pytest.raises(ValueError, match="artifacts"):
        e2e.report(str(tmp_path), json_out=os.path.join(ROOT, "artifacts", "x.json"))


def test_the_checkpoint_is_chosen_by_step_not_mtime(tmp_path):
    for step, mtime in ((4999, 1_000), (999, 2_000), (50, 3_000)):
        path = tmp_path / f"vqvae_{e2e.NAME}_step{step}.npz"
        path.write_bytes(b"")
        os.utime(path, (mtime, mtime))
    assert latest_checkpoint(str(tmp_path), e2e.NAME) == str(tmp_path / f"vqvae_{e2e.NAME}_step4999.npz")


# -- the report's rules, one passing and one failing case a row ----------------

JAX_WINDOW = e2e.final_window(os.path.join(e2e.JAX_E2E, e2e.METRICS_FILE))


def test_the_jax_records_read_as_registered():
    assert JAX_WINDOW["updates"] == 5000
    assert round(JAX_WINDOW["recon"], 4) == 0.3955 and round(JAX_WINDOW["perplexity"], 2) == 250.16
    best, epoch = e2e._best(JAX_HISTORY)
    assert len(JAX_HISTORY) == 99 and round(best, 4) == 5.6062 and epoch == 2


@pytest.mark.parametrize("recon,perplexity,want", [
    (0.4100, 280.0, (True, True)),       # +3.7%, +11.9%
    (0.4160, 288.0, (False, False)),     # +5.2%, +15.1%
    (0.3750, 212.0, (False, False)),     # -5.2%, -15.3%
])
def test_vqvae_rule(recon, perplexity, want):
    rows = e2e.vqvae_rows({"recon": recon, "perplexity": perplexity}, JAX_WINDOW)
    assert tuple(r["pass"] for r in rows) == want


@pytest.mark.parametrize("live,want", [(298, True), (340, True), (345, False), (250, False)])
def test_live_codes_rule(live, want):
    assert e2e.live_codes_row(live)["pass"] is want


def _curve(best_epoch: int, best: float, last: float, n: int = 99) -> list:
    """A validation curve falling to ``best`` at ``best_epoch``, then rising to ``last``."""
    up = np.linspace(best, last, n - best_epoch + 1)[1:]
    return [best + 0.01 * (best_epoch - e) for e in range(1, best_epoch)] + [best] + up.tolist()


@pytest.mark.parametrize("curve,want", [
    (_curve(2, 5.65, 7.8), (True, True)),      # best <= ln 298 + 0.05 = 5.747, then overfits
    (_curve(2, 5.76, 7.8), (False, True)),     # best above ln(live) + 0.05
    (_curve(6, 5.60, 7.8), (False, True)),     # best after epoch 5
    (_curve(2, 5.60, 6.5), (True, False)),     # last epoch not 1 nat above the best
])
def test_prior_rules(curve, want):
    rows = e2e.prior_rows(curve, 298, JAX_HISTORY)
    assert tuple(r["pass"] for r in rows) == want
    assert rows[0]["ln_live_codes"] == pytest.approx(math.log(298))


def _grids(unique: int, shape=(100, 8, 8)) -> np.ndarray:
    return (np.arange(int(np.prod(shape))) % unique).reshape(shape).astype(np.int32)


@pytest.mark.parametrize("codes,finite,want", [
    (_grids(260), True, True),                 # 260 >= 0.85 * 298
    (_grids(250), True, False),                # 250 < 253.3
    (_grids(260, (10, 8, 8)), True, False),    # not 100 grids
    (_grids(260) + 300, True, False),          # a code >= 512
    (_grids(260), False, False),               # images not finite
])
def test_sampling_rule(codes, finite, want):
    assert e2e.sampling_row(codes, finite, 298, 284)["pass"] is want


def _shifted(epoch: int, by: float) -> list:
    curve = list(JAX_HISTORY)
    curve[epoch - 1] += by
    return curve


@pytest.mark.parametrize("curve,want", [
    (JAX_HISTORY, (True, True, True)),
    ([v + 0.03 for v in JAX_HISTORY[:5]] + JAX_HISTORY[5:], (True, True, True)),
    (_shifted(3, 0.2), (False, True, True)),                     # epoch 3 off by 0.2 nats
    ([v + 0.06 for v in JAX_HISTORY], (True, False, True)),      # best 0.06 above JAX's
    (_curve(7, 5.60, 7.8), (True, False, True)),                 # best after epoch 5
    (JAX_HISTORY[:-1] + [JAX_HISTORY[1] + 0.9], (True, True, False)),  # no overfit at the end
])
def test_control_rules(curve, want):
    rows = e2e.control_rows(curve, JAX_HISTORY)
    assert tuple(r["pass"] for r in rows[:3]) == want
    recorded = {r["rule"]: r for r in rows[3:]}
    assert recorded["control_largest_delta"]["pass"] is None and recorded["control_last_delta"]["pass"] is None
    assert recorded["control_last_delta"]["port"] == pytest.approx(curve[-1] - JAX_HISTORY[-1])


def _records(path, live: int, history: list, codes: np.ndarray, recon: float = 0.4) -> str:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, e2e.METRICS_FILE), "w") as f:
        for step in range(150):
            f.write(json.dumps({"step": step, "recon_error": recon, "loss": recon + 0.08,
                                "perplexity": 255.0}) + "\n")
    counts = [1] * live + [0] * (512 - live)
    json.dump({"n_grids": 12000, "codes_per_grid": 64, "live_codes": live, "counts": counts},
              open(os.path.join(path, "codes_histogram.json"), "w"))
    json.dump({"train_loss": history, "val_loss": history}, open(os.path.join(path, "prior_history.json"), "w"))
    np.savez(os.path.join(path, "samples_codes.npz"), codes=codes, labels=np.arange(100) % 10,
             images_finite=True, images_shape=np.asarray([100, 32, 32, 3]))
    json.dump({"device": "card", "train_prior_100ep_s": 1.0, "total_s": 2.0},
              open(os.path.join(path, "wall_times.json"), "w"))
    return str(path)


def test_report_on_synthetic_records(tmp_path):
    good = _records(tmp_path / "good", 298, _curve(2, 5.65, 7.8), _grids(270))
    control = _records(tmp_path / "control", 298, JAX_HISTORY, _grids(270))
    payload = e2e.report(good, control)
    assert payload["all_pass"] is True
    assert [r["rule"] for r in payload["control"]["rows"]][:4] == [
        "live_codes", "control_early", "control_best", "control_overfit"]
    bad = _records(tmp_path / "bad", 298, _curve(2, 5.65, 7.8), _grids(270), recon=0.45)
    payload = e2e.report(bad, control)
    assert payload["all_pass"] is False
    assert [r["rule"] for r in payload["run"]["rows"] if not r["pass"]] == ["vqvae_recon"]
    assert e2e.main(["report", "--out", bad, "--control", control]) == 1
    assert e2e.main(["report", "--out", good, "--control", control]) == 0


# -- prior-control's extraction against the JAX package's -----------------------

_SMALL_EMA = dict(n_hiddens=16, n_residual_hiddens=8, n_residual_layers=1, embedding_dim=4,
                  n_embeddings=16, ema_codebook=True)


def test_prior_control_extracts_a_jax_ema_checkpoint_as_jax_does(tmp_path):
    """A JAX trainer's full EMA state (the leaves r5's loader once crashed on),
    saved by the JAX writer: the port's extraction of all 12,000 images in
    ``prior-control`` against the JAX package's on the same file."""
    cfg = JaxConfig(**_SMALL_EMA)
    trainer = VQVAETrainer(cfg, JaxTrainConfig(seed=3))
    state = trainer.init_state()
    ckpt = str(tmp_path / "vqvae_jax_step4999.npz")
    save_checkpoint(ckpt, state, 4999, metrics={}, hyperparameters=cfg.to_dict())

    out = str(tmp_path / "control")
    assert e2e.prior_control(out, device="cpu", checkpoint=ckpt, epochs=2, prior_flags=SMALL_PRIOR) == 0
    codes = np.load(os.path.join(out, e2e.LATENT_FILE))
    train, val, _var, _info = jax_load_dataset("CIFAR10", str(tmp_path))
    data = np.concatenate([train.data, val.data])
    j_codes = jax_extract_latents(trainer, state, data, batch_size=256)
    assert codes.shape == j_codes.reshape(len(data), -1).shape == (12000, 64)

    model, _m, _hp = load_model(ckpt, device="cpu")
    with torch.no_grad():
        z_e = model.encode(torch.from_numpy(data)).reshape(-1, 4)
    mism, near, gap = compare_assignments(z_e, model.codebook.detach(), torch.from_numpy(codes.reshape(-1)),
                                          torch.from_numpy(j_codes.reshape(-1)), "highest")
    assert mism == near, f"{mism - near} non-near-tie mismatches (gap {gap})"

    wall = json.load(open(os.path.join(out, "wall_times.json")))
    assert wall["exit_codes"] == {"extract_latents": 0, "train_prior": 0} and wall["total_s"] > 0
    assert wall["checkpoint"] == ckpt
    hist = json.load(open(os.path.join(out, "codes_histogram.json")))
    assert hist["live_codes"] == len(np.unique(codes)) and len(hist["counts"]) == 16
    prior = json.load(open(os.path.join(out, "prior_history.json")))
    assert len(prior["val_loss"]) == 1 and np.isfinite(prior["val_loss"]).all()
    payload = e2e.report(None, out)
    assert payload["run"] is None and len(payload["control"]["rows"]) == 6
