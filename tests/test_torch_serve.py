"""The port's sampling service, HTTP front end and sampling pipeline: the
cases of the JAX package's tests/test_serve.py, the decode leg held against
the JAX package's ``decode_code_grids``, and the per-thread inference mode.
"""

from __future__ import annotations

import base64
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from vqvae_tpu.config import TrainConfig as JaxTrainConfig
from vqvae_tpu.config import VQVAEConfig as JaxVQVAEConfig
from vqvae_tpu.pipelines.sample import decode_code_grids as jax_decode_code_grids
from vqvae_tpu.train.checkpoint import load_checkpoint
from vqvae_tpu.train.vqvae_train import VQVAETrainer
from vqvae_tpu_torch.config import PixelCNNConfig
from vqvae_tpu_torch.models.pixelcnn import GatedPixelCNN
from vqvae_tpu_torch.pipelines.sample import (
    decode_code_grids,
    sample_histogram_codes,
    sample_images,
    sample_uniform_codes,
)
from vqvae_tpu_torch.pipelines.serve import SamplingHTTPServer, SamplingService
from vqvae_tpu_torch.pipelines.viz import load_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VQVAE_R4 = os.path.join(ROOT, "artifacts/e2e_r4/vqvae_e2e_r4_step4999.npz")
SAMPLES_R5 = os.path.join(ROOT, "artifacts/e2e_r5/samples.npz")


def _make(batch=8, seed=0):
    cfg = PixelCNNConfig(input_dim=16, dim=8, n_layers=2, n_classes=10, img_dim=4)
    prior = GatedPixelCNN(cfg)
    prior.reset_parameters(torch.Generator().manual_seed(0))
    return cfg, SamplingService(cfg, prior.eval(), batch_size=batch, seed=seed, device="cpu")


def test_single_request():
    cfg, svc = _make()
    out = svc.sample(label=3, n_samples=5)
    assert out.shape == (5, 4, 4) and out.dtype == np.int32
    assert out.min() >= 0 and out.max() < cfg.input_dim
    assert svc.stats == {"waves": 1, "slots_used": 5}


def test_many_requests_packed_into_waves():
    cfg, svc = _make(batch=8)
    reqs = [svc.submit(label=i % 10, n_samples=3) for i in range(5)]  # 15 slots
    waves = 0
    while not all(r._event.is_set() for r in reqs):
        assert svc.run_wave() > 0
        waves += 1
    assert waves == 2 and svc.stats == {"waves": 2, "slots_used": 15}
    for r in reqs:
        assert r.result(0).shape == (3, 4, 4)


def test_large_request_spans_waves():
    cfg, svc = _make(batch=4)
    req = svc.submit(label=0, n_samples=10)
    while not req._event.is_set():
        svc.run_wave()
    assert req.result(0).shape == (10, 4, 4)
    assert svc.stats == {"waves": 3, "slots_used": 10}
    assert svc.run_wave() == 0 and svc.stats["waves"] == 3  # an empty queue runs no wave


def test_waves_follow_one_generator():
    """Two services with one seed serve the same grids; the generator moves
    on from wave to wave."""
    _cfg, a = _make(batch=4, seed=5)
    _cfg, b = _make(batch=4, seed=5)
    first, second = a.sample(2, 4), a.sample(2, 4)
    assert np.array_equal(first, b.sample(2, 4)) and not np.array_equal(first, second)


def test_background_thread():
    cfg, svc = _make()
    svc.start()
    try:
        out = svc.submit(label=1, n_samples=4).result(timeout=60)
        assert out.shape == (4, 4, 4)
    finally:
        svc.stop()
    assert svc._thread is None


def test_wave_runs_in_inference_mode_on_any_thread(monkeypatch):
    """Grad mode is per thread: the wave enters inference mode itself."""
    _cfg, svc = _make()
    seen = []
    real = svc._sampler.generate

    def spy(*a, **kw):
        seen.append((threading.current_thread().name, torch.is_inference_mode_enabled()))
        return real(*a, **kw)

    monkeypatch.setattr(svc._sampler, "generate", spy)
    svc.start()
    try:
        svc.submit(0, 2).result(timeout=60)
    finally:
        svc.stop()
    assert seen == [("sampling-waves", True)]


def test_concurrent_clients_while_background_loop_runs():
    """4 client threads call the blocking sample() while the background loop
    runs waves too: the wave lock keeps packing and draws consistent."""
    cfg, svc = _make(batch=8)
    svc.start()
    results, errors = {}, []

    def client(tid):
        try:
            for j in range(3):
                results[(tid, j)] = svc.sample(label=tid, n_samples=2 + (tid + j) % 3)
        except Exception as e:  # reported below
            errors.append((tid, repr(e)))

    threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive(), "client thread deadlocked"
    finally:
        svc.stop()
    assert not errors, errors
    assert len(results) == 12
    for (tid, j), out in results.items():
        assert out.shape == (2 + (tid + j) % 3, 4, 4)
        assert out.min() >= 0 and out.max() < cfg.input_dim
    assert svc.stats["slots_used"] == sum(2 + (t + j) % 3 for t in range(4) for j in range(3))


def _serve(decode_fn=None, batch=4):
    cfg, svc = _make(batch=batch)
    svc.start()
    server = SamplingHTTPServer(svc, decode_fn=decode_fn, port=0)
    server.start_background()
    host, port = server.address
    return cfg, svc, server, f"http://{host}:{port}"


def _post(url, payload):
    req = urllib.request.Request(url + "/sample", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _status(fn):
    try:
        fn()
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def test_http_server_roundtrip():
    """/healthz, POST /sample, 404 on another path, 400 on n_samples 0."""
    cfg, svc, server, url = _serve()
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True, "pending": 0}
        out = _post(url, {"label": 2, "n_samples": 6})
        codes = np.asarray(out["codes"])
        assert out["label"] == 2 and codes.shape == (6, 4, 4)
        assert codes.min() >= 0 and codes.max() < cfg.input_dim
        assert "images_b64" not in out  # no decoder attached
        assert _status(lambda: urllib.request.urlopen(url + "/nowhere", timeout=30)) == 404
        assert _status(lambda: _post(url + "/x", {})) == 404
        assert _status(lambda: _post(url, {"n_samples": 0})) == 400
        assert _status(lambda: _post(url, {"n_samples": 4097})) == 400
    finally:
        server.shutdown()
        svc.stop()


def test_http_decode_wire_formats():
    """b64_u8 (default) and list; the uint8 bytes are (x + 1) * 127.5 clipped."""

    def decode_fn(codes):  # a fake decoder: one [-1, 1] "pixel" per code
        return (np.asarray(codes, np.float32)[..., None] / 16) * 2.0 - 1.0

    _cfg, svc, server, url = _serve(decode_fn)
    try:
        out = _post(url, {"label": 1, "n_samples": 3, "decode": True})
        assert out["images_dtype"] == "uint8" and out["images_shape"] == [3, 4, 4, 1]
        u8 = np.frombuffer(base64.b64decode(out["images_b64"]), np.uint8).reshape(out["images_shape"])
        want = np.clip((decode_fn(np.asarray(out["codes"])) + 1.0) * 127.5, 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(u8, want)
        outl = _post(url, {"label": 1, "n_samples": 3, "decode": True, "image_format": "list"})
        np.testing.assert_allclose(np.asarray(outl["images"]), decode_fn(np.asarray(outl["codes"])))
        assert _status(lambda: _post(url, {"n_samples": 1, "decode": True,
                                           "image_format": "tiff"})) == 400
    finally:
        server.shutdown()
        svc.stop()


def test_http_b64_images_from_a_vqvae_decoder():
    """The real decode leg: 8 x 8 grids through the e2e_r4 VQ-VAE come back
    as (n, 32, 32, 3) uint8, equal to the decoder's own images."""
    vq_model, _m, _hp = load_model(VQVAE_R4, device="cpu")
    cfg = PixelCNNConfig(input_dim=512, dim=8, n_layers=2, img_dim=8)
    prior = GatedPixelCNN(cfg)
    prior.reset_parameters(torch.Generator().manual_seed(1))
    svc = SamplingService(cfg, prior.eval(), batch_size=4, device="cpu")
    svc.start()
    server = SamplingHTTPServer(svc, lambda c: decode_code_grids(vq_model, c), port=0)
    server.start_background()
    host, port = server.address
    try:
        out = _post(f"http://{host}:{port}", {"label": 4, "n_samples": 5, "decode": True})
        u8 = np.frombuffer(base64.b64decode(out["images_b64"]), np.uint8).reshape(out["images_shape"])
        assert u8.shape == (5, 32, 32, 3)
        imgs = decode_code_grids(vq_model, np.asarray(out["codes"]))
        np.testing.assert_array_equal(u8, np.clip((imgs + 1.0) * 127.5, 0, 255).astype(np.uint8))
    finally:
        server.shutdown()
        svc.stop()


def test_decode_code_grids_vs_jax():
    """The e2e_r4 (fp32) VQ-VAE decodes the 100 grids of e2e_r5's samples.npz
    as the JAX package does, atol 1e-4."""
    codes = np.load(SAMPLES_R5)["codes"][:16]
    vq_model, _m, hp = load_model(VQVAE_R4, device="cpu")
    got = decode_code_grids(vq_model, codes)
    trainer = VQVAETrainer(JaxVQVAEConfig.from_dict(hp), JaxTrainConfig())
    state, _s, _m2, _h = load_checkpoint(VQVAE_R4, trainer.init_state())
    want = jax_decode_code_grids(trainer, state, codes)
    assert got.shape == (16, 32, 32, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_sample_images_shapes():
    vq_model, _m, _hp = load_model(VQVAE_R4, device="cpu")
    prior = GatedPixelCNN(PixelCNNConfig(input_dim=512, dim=8, n_layers=2, img_dim=8))
    prior.reset_parameters(torch.Generator().manual_seed(2))
    labels = np.arange(6) % 10
    images, codes = sample_images(vq_model, prior.eval(), labels, torch.Generator().manual_seed(0))
    assert images.shape == (6, 32, 32, 3) and codes.shape == (6, 8, 8) and codes.dtype == np.int32
    np.testing.assert_array_equal(images, decode_code_grids(vq_model, codes))
    again, codes2 = sample_images(vq_model, prior, labels, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(codes, codes2)


def test_latent_sampling_schemes():
    """Notebook cells 10-12: uniform and histogram code sampling."""
    uni = sample_uniform_codes(512, 8, (8, 8), torch.Generator().manual_seed(0))
    assert uni.shape == (8, 8, 8) and uni.dtype == np.int32 and uni.min() >= 0 and uni.max() < 512
    seen = np.concatenate([np.full(900, 7), np.full(100, 3)])
    hist = sample_histogram_codes(seen, 16, (8, 8), torch.Generator().manual_seed(1))
    vals, counts = np.unique(hist, return_counts=True)
    assert hist.shape == (16, 8, 8) and set(vals.tolist()) <= {3, 7}
    assert counts[vals.tolist().index(7)] > counts[vals.tolist().index(3)]


def test_service_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PixelCNNConfig(input_dim=16, dim=8, n_layers=2, img_dim=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SamplingService(cfg, GatedPixelCNN(cfg))
