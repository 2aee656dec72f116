"""Continuous-batching sampling service (port of ``vqvae_tpu/pipelines/serve.py``).

For fixed-size grids every grid takes exactly H * W decode steps, so the
schedule is lockstep waves: keep a device batch of B slots full, decode one
wave (all slots finish together), hand out the results, refill the slots
from the queue, repeat. A grid that joined mid-wave could not finish before
the wave does, so lockstep loses nothing.

``SamplingService`` wraps the cached decoder (models/pixelcnn_sampler.py)
with a request queue, slot packing across requests (one wave serves many
small requests; a request larger than a wave spans waves), one
``torch.Generator`` advanced only under the wave lock, and occupancy
counters. ``SamplingHTTPServer`` is a stdlib JSON front end over it, with an
optional VQ-VAE decode of the grids to images.

Grad mode and ``inference_mode`` are per thread in torch: a wave enters
``torch.inference_mode()`` itself, on whichever thread runs it, and so must
the decode callback (``decode_code_grids`` does).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from vqvae_tpu_torch.config import PixelCNNConfig
from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.models.pixelcnn import GatedPixelCNN
from vqvae_tpu_torch.models.pixelcnn_sampler import CachedPixelCNNSampler


@dataclass
class SampleRequest:
    label: int
    n_samples: int
    _event: threading.Event = field(default_factory=threading.Event)
    _result: Optional[np.ndarray] = None
    _remaining: int = 0
    _chunks: List[np.ndarray] = field(default_factory=list)

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("sampling request timed out")
        return self._result


class SamplingService:
    """Continuous-batching AR sampler over a fixed device batch of slots."""

    def __init__(
        self,
        cfg: PixelCNNConfig,
        prior: GatedPixelCNN,
        batch_size: int = 64,
        seed: int = 0,
        device: str = "cuda",
    ):
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self._sampler = CachedPixelCNNSampler(prior.to(self.device))
        self._queue: "queue.Queue[SampleRequest]" = queue.Queue()
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._shape = (cfg.img_dim, cfg.img_dim)
        # One lock serializes whole waves (packing, draws, distribution):
        # sample() runs waves on caller threads while start()'s loop runs
        # them too, and both advance the one generator.
        self._wave_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # occupancy counters, guarded by _wave_lock: waves run and slots that
        # served requests; occupancy = slots_used / (waves * batch_size)
        self.stats = {"waves": 0, "slots_used": 0}

    # -- synchronous API ------------------------------------------------------

    def sample(self, label: int, n_samples: int) -> np.ndarray:
        """Enqueue and run waves until the request is served."""
        req = self.submit(label, n_samples)
        while not req._event.is_set():
            if self.run_wave() == 0:
                # a concurrent wave took the request: wait, do not spin
                req._event.wait(0.005)
        return req.result(0)

    def submit(self, label: int, n_samples: int) -> SampleRequest:
        req = SampleRequest(label, n_samples, _remaining=n_samples)
        self._queue.put(req)
        return req

    def run_wave(self) -> int:
        """Pack pending request slots into one wave, decode it, hand out the
        grids. Returns the number of slots that served requests. Callers may
        run it from several threads; waves serialize on the wave lock."""
        with self._wave_lock:
            return self._run_wave_locked()

    def _run_wave_locked(self) -> int:
        slots: List[Tuple[SampleRequest, int]] = []
        labels = np.zeros((self.batch_size,), np.int64)
        pending: List[SampleRequest] = []
        used = 0
        while used < self.batch_size:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            take = min(req._remaining, self.batch_size - used)
            labels[used: used + take] = req.label
            slots.append((req, take))
            req._remaining -= take
            if req._remaining > 0:
                pending.append(req)  # needs more slots next wave
            used += take
        for req in pending:
            self._queue.put(req)
        if used == 0:
            return 0

        with torch.inference_mode():
            grids = self._sampler.generate(
                torch.from_numpy(labels).to(self.device), self._generator, self._shape,
                self.batch_size,
            ).cpu().numpy()

        offset = 0
        for req, take in slots:
            req._chunks.append(grids[offset: offset + take])
            offset += take
            if req._remaining == 0:
                req._result = np.concatenate(req._chunks)
                req._event.set()
        self.stats["waves"] += 1
        self.stats["slots_used"] += used
        return used

    # -- background serving ---------------------------------------------------

    def start(self) -> None:
        """Run waves on a background thread whenever requests are pending."""
        if self._thread is not None:
            return

        def loop():
            while not self._stop.is_set():
                if self._queue.empty():
                    self._stop.wait(0.005)
                    continue
                self.run_wave()

        self._stop.clear()
        self._thread = threading.Thread(target=loop, name="sampling-waves", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None


class SamplingHTTPServer:
    """Stdlib HTTP JSON front end over :class:`SamplingService`.

    - ``GET /healthz`` -> ``{"ok": true, "pending": N}``
    - ``POST /sample`` with ``{"label": int, "n_samples": 1..4096, "decode":
      bool, "image_format": "b64_u8" | "list"}`` -> ``{"label", "codes"}``
      and, when a decoder is attached and ``decode`` is true, the images:
      by default base64 of raw uint8 NHWC bytes (``images_b64``,
      ``images_shape``, ``images_dtype``; [-1, 1] mapped to [0, 255] by
      (x + 1) * 127.5, clipped), or ``"list"`` for nested float lists.
    - another path -> 404; a malformed request -> 400 with ``{"error"}``.

    Requests from concurrent connections are packed into the same waves by
    the service's background loop.
    """

    def __init__(self, service: SamplingService, decode_fn=None, host: str = "127.0.0.1",
                 port: int = 0):
        import base64
        import http.server
        import json
        import socketserver

        svc = service

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"ok": True, "pending": svc._queue.qsize()})
                else:
                    self._send(404, {"error": "unknown path"})

            def do_POST(self):
                if self.path != "/sample":
                    self._send(404, {"error": "unknown path"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    label = int(req.get("label", 0))
                    count = int(req.get("n_samples", 1))
                    if not (0 < count <= 4096):
                        raise ValueError("n_samples out of range")
                    fmt = req.get("image_format", "b64_u8")
                    if fmt not in ("b64_u8", "list"):
                        raise ValueError(f"unknown image_format {fmt!r}")
                    codes = svc.submit(label, count).result(timeout=600)
                    out = {"label": label, "codes": codes.tolist()}
                    if decode_fn is not None and req.get("decode", False):
                        imgs = np.asarray(decode_fn(codes))
                        if fmt == "list":
                            out["images"] = imgs.tolist()
                        else:
                            u8 = np.clip((imgs + 1.0) * 127.5, 0.0, 255.0).astype(np.uint8)
                            out["images_b64"] = base64.b64encode(u8.tobytes()).decode("ascii")
                            out["images_shape"] = list(u8.shape)
                            out["images_dtype"] = "uint8"
                    self._send(200, out)
                except Exception as e:  # the request's error goes back to its client
                    self._send(400, {"error": str(e)})

        class _Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
            daemon_threads = True

        self._httpd = _Server((host, port), Handler)
        self.address = self._httpd.server_address
        self._thread: Optional[threading.Thread] = None

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def start_background(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever, name="sampling-http",
                                        daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        """Stop serving and close the listening socket."""
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None


__all__ = ["SampleRequest", "SamplingHTTPServer", "SamplingService"]
