"""The sampling service under concurrent mixed-size requests, on the card
(counterpart of ``tools/bench_serve.py``).

    python -m vqvae_tpu_torch.bench.serve [--wave_batch 256] [--clients 8]
        [--requests_per_client 12] [--sizes 1 4 16 64 256] [--decode_every 4]
        [--prior_layers 15] [--image_format b64_u8] [--device cpu] [--out build/bench/serve.json]

``SamplingService`` and ``SamplingHTTPServer`` on a free local port, with a
prior at the default config (``prior_layers`` deep) and a VQ-VAE decoder,
both with torch-default weights drawn from a seed (the cost of serving does
not depend on the weights). Each client thread sends its requests one after
another on one connection (a closed loop): ``n_samples`` round-robin from
``sizes``, every ``decode_every``-th also decoded to images. Latency is the
client's wall time of a request, JSON and HTTP included. Two warm-up
requests (a decode, and one larger than a wave) run before the timed window.
A request that fails, or a client that dies, fails the bench: the answered
requests must number clients x requests.
"""

from __future__ import annotations

import argparse
import http.client
import json
import sys
import threading
import time

import numpy as np

from vqvae_tpu_torch.bench import write_rows
from vqvae_tpu_torch.bench.encode import make_model
from vqvae_tpu_torch.bench.sampler import make_prior
from vqvae_tpu_torch.bench.timing import device_line
from vqvae_tpu_torch.config import PixelCNNConfig, VQVAEConfig
from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.pipelines.sample import decode_code_grids
from vqvae_tpu_torch.pipelines.serve import SamplingHTTPServer, SamplingService


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def one_request(conn, label: int, n: int, decode: bool, image_format: str = "b64_u8") -> float:
    """POST /sample and check the answer: n grids (and n images when decoded).
    The request's wall seconds."""
    body = json.dumps({"label": label, "n_samples": n, "decode": decode,
                       "image_format": image_format}).encode()
    t0 = time.perf_counter()
    conn.request("POST", "/sample", body, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    payload = json.loads(resp.read())
    dt = time.perf_counter() - t0
    if resp.status != 200:
        raise RuntimeError(f"status {resp.status}: {payload}")
    if len(payload["codes"]) != n:
        raise RuntimeError(f"asked for {n} grids, got {len(payload['codes'])}")
    if decode:
        got = len(payload["images"]) if image_format == "list" else payload["images_shape"][0]
        if got != n:
            raise RuntimeError(f"asked for {n} images, got {got}")
    return dt


def run_bench(
    wave_batch: int = 256,
    n_clients: int = 8,
    requests_per_client: int = 12,
    mixed_sizes=(1, 4, 16, 64, 256),
    decode_every: int = 4,
    prior_layers: int = 15,
    image_format: str = "b64_u8",
    device="cuda",
    prior_cfg: PixelCNNConfig = PixelCNNConfig(),
    vq_cfg: VQVAEConfig = VQVAEConfig(),
    seed: int = 0,
) -> dict:
    dev = resolve_device(device)
    cfg = prior_cfg.replace(n_layers=prior_layers)
    prior = make_prior(cfg, dev, seed)
    vq = make_model(vq_cfg, dev, seed + 1)
    service = SamplingService(cfg, prior, batch_size=wave_batch, seed=seed, device=dev)
    server = SamplingHTTPServer(service, decode_fn=lambda codes: decode_code_grids(vq, codes))
    service.start()
    server.start_background()
    host, port = server.address
    lat = []  # (n_samples, decode, seconds)
    lat_lock = threading.Lock()
    errors = []

    def client(cid: int):
        conn = http.client.HTTPConnection(host, port, timeout=600)
        try:
            for r in range(requests_per_client):
                n = mixed_sizes[(cid + r) % len(mixed_sizes)]
                decode = decode_every > 0 and r % decode_every == 0
                dt = one_request(conn, cid % 10, n, decode, image_format)
                with lat_lock:
                    lat.append((n, decode, dt))
        except Exception as e:  # a client's failure fails the bench below
            errors.append(f"client {cid}: {e!r}")
        finally:
            conn.close()

    try:
        # warm-up outside the timed window: a decode, and the multi-wave path
        conn = http.client.HTTPConnection(host, port, timeout=600)
        one_request(conn, 0, 2, True, image_format)
        one_request(conn, 0, wave_batch + 1, False)
        conn.close()
        # reset under the wave lock: the loop counts a wave after it has
        # answered, so the last warm-up wave could land in a fresh dict
        with service._wave_lock:
            service.stats = {"waves": 0, "slots_used": 0}
        threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        service.stop()

    asked = n_clients * requests_per_client
    if errors or len(lat) != asked:
        raise RuntimeError(f"{len(lat)} of {asked} requests answered: {errors}")
    total_grids = sum(n for n, _, _ in lat)
    all_lat = [dt for _, _, dt in lat]
    dec_lat = [dt for _, d, dt in lat if d]
    plain_lat = [dt for _, d, dt in lat if not d]
    waves = service.stats["waves"]
    return {
        "wave_batch": wave_batch,
        "n_clients": n_clients,
        "requests": len(lat),
        "request_mix_n_samples": list(mixed_sizes),
        "decode_every": decode_every,
        "image_format": image_format,
        "prior_layers": prior_layers,
        "wall_seconds": wall,
        "grids_per_sec": total_grids / wall,
        "requests_per_sec": len(lat) / wall,
        "latency_p50_ms": _percentile(all_lat, 50) * 1e3,
        "latency_p99_ms": _percentile(all_lat, 99) * 1e3,
        "latency_decode_p50_ms": _percentile(dec_lat, 50) * 1e3 if dec_lat else None,
        "latency_plain_p50_ms": _percentile(plain_lat, 50) * 1e3 if plain_lat else None,
        "waves": waves,
        "wave_occupancy": service.stats["slots_used"] / (waves * wave_batch) if waves else 0.0,
        "device": device_line(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vqvae_tpu_torch.bench.serve")
    ap.add_argument("--wave_batch", type=int, default=256)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests_per_client", type=int, default=12)
    ap.add_argument("--sizes", type=int, nargs="*", default=[1, 4, 16, 64, 256],
                    help="mixed request sizes, assigned round-robin across clients")
    ap.add_argument("--decode_every", type=int, default=4,
                    help="every k-th request per client also decodes to images")
    ap.add_argument("--prior_layers", type=int, default=15)
    ap.add_argument("--image_format", type=str, default="b64_u8", choices=["b64_u8", "list"])
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", type=str, default=None, help="also write the row to this JSON file")
    args = ap.parse_args(argv)
    row = run_bench(args.wave_batch, args.clients, args.requests_per_client, args.sizes,
                    args.decode_every, args.prior_layers, args.image_format, args.device)
    write_rows({"metric": "SamplingService+HTTP under concurrent mixed-size requests "
                          "(lockstep waves; client latencies include JSON and HTTP)",
                "row": row}, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
