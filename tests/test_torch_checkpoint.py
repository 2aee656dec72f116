"""Checkpoints cross between the two packages in both directions, with the
optimizer state, and what does not fit is refused.

Arrays that only change layout on the way (every leaf of a checkpoint) are
compared bit for bit. Where a step is taken after a load, the two packages'
results are held to the tolerances of tests/test_torch_train.py (fp32 on both
sides, summation order only: metrics rtol 1e-5, moments rtol 1e-4).
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest
import torch

from vqvae_tpu.config import MeshConfig
from vqvae_tpu.config import TrainConfig as JaxTrainConfig
from vqvae_tpu.config import VQVAEConfig as JaxConfig
from vqvae_tpu.train import checkpoint as jax_checkpoint
from vqvae_tpu.train.vqvae_train import VQVAETrainer as JaxTrainer
from vqvae_tpu_torch.config import TrainConfig, VQVAEConfig
from vqvae_tpu_torch.train.checkpoint import (
    AsyncCheckpointer,
    check_hyperparameters_compatible,
    checkpoint_path,
    flatten_tree,
    latest_checkpoint,
    load_checkpoint,
    params_from_jax,
    params_to_jax,
    peek_hyperparameters,
    save_checkpoint,
    train_state_to_jax,
)
from vqvae_tpu_torch.train.vqvae_train import VQVAETrainer, metrics_to_host

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R4 = os.path.join(ROOT, "artifacts/e2e_r4/vqvae_e2e_r4_step4999.npz")
TINY = dict(n_hiddens=16, n_residual_hiddens=8, n_embeddings=64, embedding_dim=16)
X_VAR = 0.06


def _batch(seed: int, n: int = 16) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)


def _port_trainer(**extra):
    return VQVAETrainer(VQVAEConfig(**TINY, **extra), TrainConfig(batch_size=16, seed=2),
                        x_train_var=X_VAR, device="cpu")


def _jax_trainer(**extra):
    return JaxTrainer(JaxConfig(**TINY, **extra), JaxTrainConfig(batch_size=16),
                      MeshConfig(n_data=1), x_train_var=X_VAR)


def _file_arrays(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: np.asarray(data[k]) for k in data.files if k != "__meta__"}


@pytest.mark.parametrize("ema", [False, True], ids=["gradient", "ema"])
def test_port_checkpoint_loads_into_the_jax_train_state(tmp_path, ema):
    """Two port steps, save, ``vqvae_tpu.train.checkpoint.load_checkpoint``
    into the JAX template; then one more step in each package agrees."""
    pt = _port_trainer(ema_codebook=ema)
    ps = pt.init_state()
    for seed in (1, 2):
        ps, _m = pt.step(ps, _batch(seed))
    path = str(tmp_path / "vqvae_port_step1.npz")
    save_checkpoint(path, ps, 1, metrics={"loss_vals": [1.0, 2.0]},
                    hyperparameters=pt.vq_cfg.to_dict())

    jt = _jax_trainer(ema_codebook=ema)
    js, step, metrics, hp = jax_checkpoint.load_checkpoint(path, jt.init_state())
    assert step == 1 and metrics == {"loss_vals": [1.0, 2.0]}
    assert JaxConfig.from_dict(hp) == JaxConfig(**TINY, ema_codebook=ema)
    assert int(js.step) == 2 and int(js.opt_state[0].count) == 2
    assert (js.ema_counts is not None) == ema
    want = flatten_tree(train_state_to_jax(ps))
    got = jax_checkpoint._flatten_state(js)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), want[key], err_msg=key)

    x = _batch(3)
    js, j_m = jt.step(jax.device_put(js, jt._rep), x)
    ps, p_m = pt.step(ps, x)
    for name, value in metrics_to_host(p_m).items():
        np.testing.assert_allclose(value, float(j_m[name]), rtol=1e-5, err_msg=name)
    got = flatten_tree(train_state_to_jax(ps))
    for key, w in jax_checkpoint._flatten_state(js).items():
        if ".opt_state[0].mu" in key:
            np.testing.assert_allclose(got[key], np.asarray(w), rtol=1e-4, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("ema", [False, True], ids=["gradient", "ema"])
def test_jax_checkpoint_loads_into_the_port_with_optimizer_state(tmp_path, ema):
    jt = _jax_trainer(ema_codebook=ema)
    js = jt.init_state()
    for seed in (1, 2):
        js, _m = jt.step(js, _batch(seed))
    path = str(tmp_path / "vqvae_jax_step1.npz")
    jax_checkpoint.save_checkpoint(path, js, 1, metrics={"n_updates": 1},
                                   hyperparameters=jt.vq_cfg.to_dict())
    pt = _port_trainer(ema_codebook=ema)
    ps, step, metrics, hp = load_checkpoint(path, pt.init_state())
    assert step == 1 and metrics == {"n_updates": 1} and hp == peek_hyperparameters(path)
    assert ps.step == 2 and ps.optimizer.count == 2
    got, want = flatten_tree(train_state_to_jax(ps)), _file_arrays(path)
    assert set(got) == set(want) and len(want) == (96 if ema else 94)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the moments are live: a nonzero mu for a conv kernel, in torch's layout
    mu = ps.optimizer.state[ps.model.encoder.conv1_w]["mu"]
    assert mu.shape == (8, 3, 4, 4) and mu.abs().max() > 0


def test_full_width_tree_of_94_leaves_both_ways(tmp_path):
    """The trained full-width checkpoint of the JAX package (artifacts/e2e_r4)
    loads into the port with its optimizer state; the port writes it back
    with every leaf bit for bit, and the JAX package's loader takes that file
    into its full-width ``TrainState`` by key, shape and dtype."""
    hp = peek_hyperparameters(R4)
    pt = VQVAETrainer(VQVAEConfig.from_dict(hp), TrainConfig.from_dict(hp),
                      x_train_var=hp["x_train_var"], device="cpu")
    assert TrainConfig.from_dict(hp).to_dict() == {
        k: hp[k] for k in TrainConfig().to_dict()}  # the stored dict round-trips
    ps, step, metrics, _hp = load_checkpoint(R4, pt.init_state())
    assert step == 4999 and ps.step == 5000 and ps.optimizer.count == 5000
    assert len(metrics["loss_vals"]) == 5000
    nu_max = ps.optimizer.state[ps.model.decoder.convt1_w]["nu_max"]
    assert nu_max.shape == (64, 128, 3, 3) and nu_max.min() >= 0 and nu_max.max() > 0
    out = str(tmp_path / "vqvae_back_step4999.npz")
    save_checkpoint(out, ps, step, metrics=metrics, hyperparameters=hp)
    want, got = _file_arrays(R4), _file_arrays(out)
    assert len(want) == 94 and set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    with np.load(out, allow_pickle=False) as data:
        assert json.loads(str(data["__meta__"]))["n_leaves"] == 94
    jt = JaxTrainer(JaxConfig.from_dict(hp), JaxTrainConfig(), MeshConfig(n_data=1))
    js, j_step, _m, _h = jax_checkpoint.load_checkpoint(out, jt.init_state())
    assert j_step == 4999 and len(jax.tree_util.tree_leaves(js)) == 94
    np.testing.assert_array_equal(np.asarray(js.params["decoder"]["convt1_w"]),
                                  want["leaf::.params['decoder']['convt1_w']"])


def test_params_to_jax_inverts_params_from_jax():
    ps = _port_trainer(share_residual_weights=True).init_state()
    named = dict(ps.model.named_parameters())
    tree = params_to_jax(named)
    assert tree["encoder"]["conv1_w"].shape == (4, 4, 3, 8)             # HWIO
    assert tree["decoder"]["convt2_w"].shape == (4, 4, 16, 8)           # (kh, kw, in, out)
    assert tree["decoder"]["res_stack"]["ResidualLayer_0"]["conv3x3"].shape == (3, 3, 16, 8)
    back = params_from_jax(tree)
    assert set(back) == set(named)
    for name, p in named.items():
        assert torch.equal(back[name], p.detach()), name


def test_mismatched_files_are_refused(tmp_path):
    ps = _port_trainer().init_state()
    path = str(tmp_path / "vqvae_a_step0.npz")
    save_checkpoint(path, ps, 0, hyperparameters=VQVAEConfig(**TINY).to_dict())
    # key set: an EMA template wants two leaves the file lacks, and the reverse
    with pytest.raises(ValueError, match="tree mismatch.*ema_counts"):
        load_checkpoint(path, _port_trainer(ema_codebook=True).init_state())
    ema_path = str(tmp_path / "vqvae_e_step0.npz")
    save_checkpoint(ema_path, _port_trainer(ema_codebook=True).init_state(), 0)
    with pytest.raises(ValueError, match="unexpected leaves.*ema_counts"):
        load_checkpoint(ema_path, ps)
    # key set: shared residual weights live under another key
    with pytest.raises(ValueError, match="tree mismatch"):
        load_checkpoint(path, _port_trainer(share_residual_weights=True).init_state())
    # shape
    wide = VQVAETrainer(VQVAEConfig(**{**TINY, "n_hiddens": 32}), TrainConfig(), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, wide.init_state())
    # dtype: the step as int64, a moment as float64
    arrays = _file_arrays(path)
    with np.load(path, allow_pickle=False) as data:
        meta = str(data["__meta__"])
    for key, dtype in (("leaf::.step", np.int64), ("leaf::.opt_state[0].nu['codebook']", np.float64)):
        bad = str(tmp_path / "bad.npz")
        np.savez(bad, __meta__=meta, **{**arrays, key: arrays[key].astype(dtype)})
        with pytest.raises(ValueError, match="dtype"):
            load_checkpoint(bad, ps)
    # a key path that is none of the train state's
    np.savez(bad, __meta__=meta, **arrays, **{"leaf::.extra['w']": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="unrecognised checkpoint key"):
        load_checkpoint(bad, ps)
    # v1 (positional) files are not supported
    np.savez(bad, __meta__=json.dumps({"format_version": 1, "step": 0, "n_leaves": 1}),
             leaf_0=np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="not supported"):
        load_checkpoint(bad, ps)
    # a refused load leaves the template as it was
    before = flatten_tree(train_state_to_jax(ps))
    with pytest.raises(ValueError):
        load_checkpoint(ema_path, ps)
    for key, value in flatten_tree(train_state_to_jax(ps)).items():
        np.testing.assert_array_equal(value, before[key])


def test_check_hyperparameters_compatible_names_the_field(tmp_path):
    path = str(tmp_path / "vqvae_a_step0.npz")
    cfg = VQVAEConfig(**TINY, ema_codebook=True)
    save_checkpoint(path, _port_trainer(ema_codebook=True).init_state(), 0,
                    hyperparameters=cfg.to_dict())
    fields = ("n_hiddens", "ema_codebook", "n_embeddings")
    check_hyperparameters_compatible(path, cfg.to_dict(), fields)
    with pytest.raises(ValueError, match="ema_codebook: checkpoint=True vs flags=False"):
        check_hyperparameters_compatible(path, cfg.replace(ema_codebook=False).to_dict(), fields)
    with pytest.raises(ValueError, match="n_hiddens: checkpoint=16 vs flags=128"):
        check_hyperparameters_compatible(path, cfg.replace(n_hiddens=128).to_dict(), fields)
    # the JAX package's checker reads the port's file the same way
    with pytest.raises(ValueError, match="n_embeddings"):
        jax_checkpoint.check_hyperparameters_compatible(
            path, cfg.replace(n_embeddings=512).to_dict(), fields)


def test_paths_latest_and_atomic_write(tmp_path):
    ps = _port_trainer().init_state()
    assert latest_checkpoint(str(tmp_path / "none"), "run") is None
    for step in (0, 50, 100, 9):
        save_checkpoint(checkpoint_path(str(tmp_path), "run", step), ps, step)
    save_checkpoint(checkpoint_path(str(tmp_path), "other", 500), ps, 500)
    assert latest_checkpoint(str(tmp_path), "run") == os.path.join(tmp_path, "vqvae_run_step100.npz")
    assert latest_checkpoint(str(tmp_path), "run") == jax_checkpoint.latest_checkpoint(str(tmp_path), "run")
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_async_checkpointer_snapshots_and_surfaces_errors(tmp_path):
    pt = _port_trainer(ema_codebook=True)
    ps = pt.init_state()
    ps, _m = pt.step(ps, _batch(1))
    before = flatten_tree(train_state_to_jax(ps))
    writer = AsyncCheckpointer()
    path = str(tmp_path / "vqvae_async_step0.npz")
    writer.save(path, ps, 0)
    ps, _m = pt.step(ps, _batch(2))  # changes parameters and moments in place
    writer.wait()
    saved = _file_arrays(path)
    for key, value in before.items():
        np.testing.assert_array_equal(saved[key], value, err_msg=key)
    assert not np.array_equal(saved["leaf::.params['pre_quant_b']"],
                              flatten_tree(train_state_to_jax(ps))["leaf::.params['pre_quant_b']"])
    # a write that fails (the directory is a file) is raised by the next wait or save
    blocker = tmp_path / "blocked"
    blocker.write_text("a file where a directory is wanted")
    writer.save(str(blocker / "vqvae_x_step1.npz"), ps, 1)
    with pytest.raises(OSError):
        writer.wait()
    writer.wait()  # the error was handed over once
    writer.save(str(blocker / "vqvae_x_step2.npz"), ps, 2)
    with pytest.raises(OSError):
        writer.save(path, ps, 3)
