"""The reference's whole pipeline at its own scale on the card (counterpart of
``tools/run_e2e_r5.sh``), the prior trained on the JAX run's own latents, and
both held against the JAX run's records (``artifacts/e2e_r5/``).

    python -m vqvae_tpu_torch.bench.e2e run --out DIR [--device cuda] [--seed 0]
    python -m vqvae_tpu_torch.bench.e2e prior-control --out DIR2 [--device cuda] [--seed 0]
    python -m vqvae_tpu_torch.bench.e2e report --out DIR [--control DIR2] [--json PATH]

``run`` chains the script's four commands with its flags: ``train-vqvae``
for 5,000 updates (EMA codebook, bf16, the ``default`` search, chunks of 50,
saving), ``extract-latents`` of the 12,000 images with the checkpoint of the
highest step (by the number in its name), ``train-prior`` for 100 epochs at
the reference defaults on those grids, and ``sample`` of a 10 x 10 grid. Each
stage runs in a fresh process (``python -u -m vqvae_tpu_torch.bench.e2e stage
<command> ...``: the CLI's ``main``, then one line with the kernel launches
of that process), so a long process's garbage-collector slow-down stays out
of the next stage. Each stage's output goes to ``DIR/<stage>.log`` and to
this process's stdout; a stage that exits non-zero stops the run with its
exit code, and no later stage runs on stale files. The kernels are built once
before the first stage, and that time is recorded apart from the stages'.

Beside the checkpoints (about 12.5 MB each, 100 of them: keep ``DIR`` out of
the repository) the run writes the small records ``report`` reads:
``wall_times.json`` (the JAX script's keys, the card's ``nvidia-smi`` line,
the torch version, each stage's exit code and launches, the seconds of each
prior epoch), the metrics JSONL, ``codes_histogram.json`` (the extracted
codes' use), ``prior_history.json`` (the stored history of the prior's last
checkpoint, as the JAX run exported it) and ``samples_codes.npz`` (the sampled
codes and labels, whether the images were finite). ``copy_records`` copies
them with the logs. A PNG of the samples is drawn only where matplotlib
imports; its absence is recorded, never a failure.

``prior-control`` extracts the latents of the JAX run's own checkpoint
(``artifacts/e2e_r5/vqvae_e2e_r5_step4999.npz``) with the port's
``extract-latents`` and trains the same prior on them, so its validation
curve can be held epoch by epoch against the JAX run's
(``prior_history.json``): a prior trained on the port's own latents sees
another set of codes, and its cross-entropy sits near ln(live codes).

``report`` holds the records against the JAX run's by the rules in
``RULES``, fixed before the first run on the card. It reads ``artifacts/``
only, and writes one JSON where ``--json`` names a file outside it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from vqvae_tpu_torch.bench.parity import JAX_RECORDS, ROOT, _refuse_jax_records
from vqvae_tpu_torch.device import resolve_device

NAME = "e2e_r5"
JAX_E2E = os.path.join(JAX_RECORDS, "e2e_r5")
JAX_CHECKPOINT = os.path.join(JAX_E2E, "vqvae_e2e_r5_step4999.npz")
METRICS_FILE = f"vqvae_{NAME}_metrics.jsonl"
PRIOR_FILE = "latent_block_pixelcnn.npz"
LATENT_FILE = "latent_e_indices.npy"
# the records a run leaves besides checkpoints, latents and samples
RECORDS = ("wall_times.json", METRICS_FILE, "codes_histogram.json", "prior_history.json",
           "samples_codes.npz", "train_vqvae.log", "extract_latents.log", "train_prior.log",
           "sample.log")
# the JAX script's keys of wall_times.json, by stage
WALL_KEYS = {"train_vqvae": "train_vqvae_5k_s", "extract_latents": "extract_latents_s",
             "train_prior": "train_prior_100ep_s", "sample": "sample_10x10_s"}
TRAIN_FLAGS = ("--steps_per_dispatch", "50", "--ema_codebook", "--compute_dtype", "bfloat16",
               "--quantizer_precision", "default")
PRIOR_FLAGS = ("--n_layers", "15", "--img_dim", "8", "--steps_per_dispatch", "50")
LAUNCHES_TAG = "e2e stage kernel launches:"
_EPOCH_RE = re.compile(r"^Epoch (\d+):")

# The JAX run's figures that its committed files do not hold (README.md).
JAX_LIVE_CODES = 298
WINDOW = 100                     # the VQ-VAE's final window, updates
RULES = {
    "vqvae_recon": "mean recon_error of the last 100 updates within +-5% of the JAX run's",
    "vqvae_perplexity": "mean perplexity of the last 100 updates within +-15% of the JAX run's",
    "live_codes": "live codes in the extracted grids within +-15% of the JAX run's 298",
    "prior_best": "best validation CE <= ln(the run's own live codes) + 0.05, at epoch <= 5",
    "prior_overfit": "validation CE at the last epoch > best + 1.0",
    "sampling": "unique codes in the sampled grids >= 85% of the run's own live codes; codes "
                "(100, 8, 8) in [0, 512); finite images",
    "control_early": "validation CE of epochs 1-5 each within 0.1 nats of the JAX run's",
    "control_best": "best validation CE within 0.05 of the JAX run's best, at epoch <= 5",
    "control_overfit": "validation CE at the last epoch > best + 1.0",
}
REL_RECON, REL_PERPLEXITY, REL_LIVE = 0.05, 0.15, 0.15
CE_MARGIN, BEST_EPOCH_MAX, OVERFIT_NATS = 0.05, 5, 1.0
SAMPLE_SHARE, SAMPLE_SHAPE, N_CODES = 0.85, (100, 8, 8), 512
CONTROL_EARLY_EPOCHS, CONTROL_EARLY_NATS, CONTROL_BEST_NATS = 5, 0.1, 0.05


def stage(argv: Sequence[str]) -> int:
    """One stage: ``vqvae_tpu_torch.cli.main(argv)`` in this process, then
    the launches of each nearest-code kernel it made, on a line of its own."""
    from vqvae_tpu_torch import cli
    from vqvae_tpu_torch.ops import cuda_quantizer

    rc = cli.main(list(argv))
    print(f"{LAUNCHES_TAG} {json.dumps(cuda_quantizer.launches_by_route)}", flush=True)
    return rc


class _Pipeline:
    """The stages of one directory, run one by one into its ``wall_times.json``."""

    def __init__(self, out: str, device: str, scale: dict):
        from vqvae_tpu_torch.bench.timing import device_line

        self.out = os.path.abspath(out)
        _refuse_jax_records(self.out)
        dev = resolve_device(device)
        os.makedirs(self.out, exist_ok=True)
        self.device = device
        self.env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
        self.record = {"device": device_line(dev), "torch": torch.__version__, "scale": scale,
                       "kernel_build_s": None, "exit_codes": {}, "launches": {}}
        if dev.type == "cuda":
            from vqvae_tpu_torch.ops import cuda_quantizer

            # once, here: the stages then load the built library
            t0 = time.perf_counter()
            cuda_quantizer.build()
            self.record["kernel_build_s"] = time.perf_counter() - t0
        self.t0 = time.perf_counter()

    def path(self, name: str) -> str:
        return os.path.join(self.out, name)

    def run(self, name: str, argv: List[str]) -> int:
        """Run one stage, its output tee'd to ``<name>.log``; its exit code."""
        cmd = [sys.executable, "-u", "-m", "vqvae_tpu_torch.bench.e2e", "stage", *argv,
               "--device", self.device]
        print(f"=== {time.strftime('%H:%M:%S')} {name}: {' '.join(cmd[3:])}", flush=True)
        epoch_starts, launches = [], None
        t0 = time.perf_counter()
        with open(self.path(f"{name}.log"), "w") as log, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT,
                env=self.env) as proc:
            for line in proc.stdout:
                log.write(line)
                sys.stdout.write(line)
                if _EPOCH_RE.match(line):
                    epoch_starts.append(time.perf_counter() - t0)
                elif line.startswith(LAUNCHES_TAG):
                    launches = json.loads(line[len(LAUNCHES_TAG):])
            rc = proc.wait()
        seconds = time.perf_counter() - t0
        self.record[WALL_KEYS[name]] = seconds
        self.record["exit_codes"][name] = rc
        self.record["launches"][name] = launches
        if epoch_starts:
            ends = epoch_starts[1:] + [seconds]
            self.record["prior_epoch_s"] = [b - a for a, b in zip(epoch_starts, ends)]
        sys.stdout.flush()
        self.write()
        if rc != 0:
            print(f"stage {name} exited {rc}: the run stops here", flush=True)
        return rc

    def write(self, done: bool = False) -> None:
        if done:
            self.record["total_s"] = time.perf_counter() - self.t0
        with open(self.path("wall_times.json"), "w") as f:
            json.dump(self.record, f, indent=2)

    def latents_and_prior(self, checkpoint: str, seed: int, epochs: int, prior_flags: Sequence[str]) -> int:
        """``extract-latents`` with ``checkpoint`` and ``train-prior`` on its
        grids, each followed by its record (the codes' use, the prior's
        history); 0 or the failed stage's exit code."""
        from vqvae_tpu_torch.train.checkpoint import peek_hyperparameters, read_checkpoint

        n_codes = int(peek_hyperparameters(checkpoint).get("n_embeddings", N_CODES))
        rc = self.run("extract_latents", ["extract-latents", "--checkpoint", checkpoint,
                                          "--out", self.path(LATENT_FILE)])
        if rc:
            return rc
        codes = np.load(self.path(LATENT_FILE))
        counts = np.bincount(codes.ravel(), minlength=n_codes)
        live = int((counts > 0).sum())
        with open(self.path("codes_histogram.json"), "w") as f:
            json.dump({"n_grids": int(codes.shape[0]), "codes_per_grid": int(codes.shape[1]),
                       "live_codes": live, "counts": counts.tolist()}, f)
        print(f"extracted {codes.shape} codes, {live} of {n_codes} codes live", flush=True)
        rc = self.run("train_prior", ["train-prior", "--epochs", str(epochs), *PRIOR_FLAGS, "-save",
                                      "--data_dir", self.out, "--results_dir", self.out, "--seed", str(seed),
                                      "--n_embeddings", str(n_codes), *prior_flags])
        if rc:
            return rc
        # the history stored in the prior's checkpoint (every epoch's, as
        # -save writes the file after each), as the JAX run exported it
        _params, epoch, metrics, _hp = read_checkpoint(self.path(PRIOR_FILE))
        history = {key: [float(v) for v in metrics.get(key, [])] for key in ("train_loss", "val_loss")}
        with open(self.path("prior_history.json"), "w") as f:
            json.dump(history, f, indent=2)
        self.record["prior_checkpoint_epoch"] = epoch
        return 0


def run(out: str, device: str = "cuda", seed: int = 0, n_updates: int = 5000, epochs: int = 100,
        n_samples: int = 100, model_flags: Sequence[str] = (), prior_flags: Sequence[str] = ()) -> int:
    """The four stages into ``out``; 0, or the exit code of the stage that
    failed. ``model_flags`` and ``prior_flags`` are added to ``train-vqvae``'s
    and ``train-prior``'s flags (a test's small widths)."""
    from vqvae_tpu_torch.train.checkpoint import latest_checkpoint

    p = _Pipeline(out, device, {"n_updates": n_updates, "epochs": epochs, "n_samples": n_samples})
    rc = p.run("train_vqvae", ["train-vqvae", "--n_updates", str(n_updates), *TRAIN_FLAGS, "-save",
                               "--filename", NAME, "--results_dir", p.out, "--seed", str(seed),
                               *model_flags])
    if rc:
        return rc
    ckpt = latest_checkpoint(p.out, NAME)  # by the step in its name, not by mtime
    print(f"using checkpoint {ckpt}", flush=True)
    p.record["checkpoint"] = os.path.basename(ckpt)
    rc = p.latents_and_prior(ckpt, seed, epochs, prior_flags)
    if rc:
        return rc
    png = None
    if importlib.util.find_spec("matplotlib") is not None:
        png = p.path("samples_grid.png")
    else:
        p.record["png"] = "not drawn: matplotlib is not installed"
    rc = p.run("sample", ["sample", "--vqvae-checkpoint", ckpt, "--prior-checkpoint",
                          p.path(PRIOR_FILE), "--n_samples", str(n_samples), "--out",
                          p.path("samples.npz"), "--seed", str(seed),
                          *(("--png", png) if png else ())])
    if rc:
        return rc
    if png:
        p.record["png"] = os.path.basename(png)
    with np.load(p.path("samples.npz")) as d:
        images = d["images"]
        np.savez_compressed(p.path("samples_codes.npz"), codes=d["codes"], labels=d["labels"],
                            images_finite=bool(np.isfinite(images).all()),
                            images_shape=np.asarray(images.shape))
    p.write(done=True)
    print(f"E2E DONE in {p.record['total_s']:.1f} s", flush=True)
    return 0


def prior_control(out: str, device: str = "cuda", seed: int = 0, checkpoint: str = JAX_CHECKPOINT,
                  epochs: int = 100, prior_flags: Sequence[str] = ()) -> int:
    """The JAX run's checkpoint through the port's ``extract-latents``, then
    the same ``train-prior`` on those grids into ``out``; 0 or the failed
    stage's exit code."""
    p = _Pipeline(out, device, {"epochs": epochs})
    p.record["checkpoint"] = os.path.relpath(checkpoint, ROOT) if checkpoint.startswith(ROOT) else checkpoint
    rc = p.latents_and_prior(checkpoint, seed, epochs, prior_flags)
    if rc:
        return rc
    p.write(done=True)
    print(f"PRIOR CONTROL DONE in {p.record['total_s']:.1f} s", flush=True)
    return 0


def copy_records(src: str, dst: str) -> List[str]:
    """Copy a run's small records (``RECORDS``, those present) from ``src`` to ``dst``."""
    _refuse_jax_records(dst)
    os.makedirs(dst, exist_ok=True)
    copied = []
    for name in RECORDS:
        if os.path.exists(os.path.join(src, name)):
            shutil.copy2(os.path.join(src, name), os.path.join(dst, name))
            copied.append(name)
    return copied


# -- report ------------------------------------------------------------------


def _row(rule: str, port, jax, passed: Optional[bool], **extra) -> dict:
    return {"rule": rule, "criterion": RULES.get(rule, "recorded, not judged"), "port": port,
            "jax": jax, "pass": passed, **extra}


def final_window(metrics_path: str) -> dict:
    """Mean recon_error and perplexity of the last ``WINDOW`` updates of a metrics JSONL."""
    with open(metrics_path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    last = recs[-WINDOW:]
    return {"updates": len(recs),
            "recon": float(np.mean([r["recon_error"] for r in last])),
            "perplexity": float(np.mean([r["perplexity"] for r in last]))}


def vqvae_rows(port: dict, jax: dict) -> list:
    def rel(key):
        return port[key] / jax[key] - 1.0

    return [_row("vqvae_recon", port["recon"], jax["recon"], abs(rel("recon")) <= REL_RECON,
                 rel_diff=rel("recon")),
            _row("vqvae_perplexity", port["perplexity"], jax["perplexity"],
                 abs(rel("perplexity")) <= REL_PERPLEXITY, rel_diff=rel("perplexity"))]


def live_codes_row(live: int, jax_live: int = JAX_LIVE_CODES) -> dict:
    rel = live / jax_live - 1.0
    return _row("live_codes", live, jax_live, abs(rel) <= REL_LIVE, rel_diff=rel)


def _best(val_loss: Sequence[float]) -> tuple:
    i = int(np.argmin(val_loss))
    return float(val_loss[i]), i + 1  # epochs count from 1


def prior_rows(val_loss: Sequence[float], live: int, jax_val_loss: Sequence[float]) -> list:
    """The prior trained on the run's own latents: the best CE against
    ln(live codes), and the overfit after it."""
    best, epoch = _best(val_loss)
    jax_best, jax_epoch = _best(jax_val_loss)
    ceiling = math.log(live) + CE_MARGIN
    return [_row("prior_best", {"best": best, "epoch": epoch}, {"best": jax_best, "epoch": jax_epoch},
                 best <= ceiling and epoch <= BEST_EPOCH_MAX, ln_live_codes=math.log(live)),
            _row("prior_overfit", {"last": float(val_loss[-1]), "epochs": len(val_loss)},
                 {"last": float(jax_val_loss[-1]), "epochs": len(jax_val_loss)},
                 float(val_loss[-1]) > best + OVERFIT_NATS)]


def sampling_row(codes: np.ndarray, images_finite: bool, live: int, jax_unique: int) -> dict:
    unique = int(len(np.unique(codes)))
    ok = (unique >= SAMPLE_SHARE * live and tuple(codes.shape) == SAMPLE_SHAPE
          and int(codes.min()) >= 0 and int(codes.max()) < N_CODES and bool(images_finite))
    return _row("sampling", {"unique_codes": unique, "shape": list(codes.shape),
                             "images_finite": bool(images_finite)},
                {"unique_codes": jax_unique, "live_codes": JAX_LIVE_CODES}, ok,
                share_of_live=unique / live)


def control_rows(val_loss: Sequence[float], jax_val_loss: Sequence[float]) -> list:
    """The prior on the JAX run's own latents, epoch by epoch against its curve."""
    n = min(len(val_loss), len(jax_val_loss))
    delta = np.asarray(val_loss[:n], np.float64) - np.asarray(jax_val_loss[:n], np.float64)
    early = delta[:CONTROL_EARLY_EPOCHS]
    best, epoch = _best(val_loss)
    jax_best, jax_epoch = _best(jax_val_loss)
    return [_row("control_early", [float(v) for v in val_loss[:CONTROL_EARLY_EPOCHS]],
                 [float(v) for v in jax_val_loss[:CONTROL_EARLY_EPOCHS]],
                 len(early) == CONTROL_EARLY_EPOCHS and bool(np.all(np.abs(early) <= CONTROL_EARLY_NATS)),
                 delta=early.tolist()),
            _row("control_best", {"best": best, "epoch": epoch}, {"best": jax_best, "epoch": jax_epoch},
                 abs(best - jax_best) <= CONTROL_BEST_NATS and epoch <= BEST_EPOCH_MAX),
            _row("control_overfit", {"last": float(val_loss[-1]), "epochs": len(val_loss)},
                 {"last": float(jax_val_loss[-1]), "epochs": len(jax_val_loss)},
                 float(val_loss[-1]) > best + OVERFIT_NATS),
            _row("control_largest_delta", float(np.max(np.abs(delta))), None, None,
                 at_epoch=int(np.argmax(np.abs(delta))) + 1),
            _row("control_last_delta", float(delta[-1]), None, None, epochs_compared=n)]


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def report(out: Optional[str], control: Optional[str] = None, json_out: Optional[str] = None) -> dict:
    """The rows of ``RULES`` for the run in ``out`` and the control run in
    ``control``, against the JAX run's records (``JAX_E2E``, read only)."""
    if json_out:
        _refuse_jax_records(json_out)
    jax_history = _read_json(os.path.join(JAX_E2E, "prior_history.json"))["val_loss"]
    with np.load(os.path.join(JAX_E2E, "samples.npz")) as d:
        jax_unique = int(len(np.unique(d["codes"])))
    payload = {"rules": RULES, "jax_records": os.path.relpath(JAX_E2E, ROOT), "run": None, "control": None}
    if out:
        live = _read_json(os.path.join(out, "codes_histogram.json"))["live_codes"]
        history = _read_json(os.path.join(out, "prior_history.json"))["val_loss"]
        with np.load(os.path.join(out, "samples_codes.npz")) as d:
            codes, finite = d["codes"], bool(d["images_finite"])
        rows = (vqvae_rows(final_window(os.path.join(out, METRICS_FILE)),
                           final_window(os.path.join(JAX_E2E, METRICS_FILE)))
                + [live_codes_row(live)] + prior_rows(history, live, jax_history)
                + [sampling_row(codes, finite, live, jax_unique)])
        payload["run"] = {"dir": os.path.basename(os.path.normpath(out)), "wall_times": _read_json(os.path.join(out, "wall_times.json")),
                          "rows": rows}
    if control:
        wall = _read_json(os.path.join(control, "wall_times.json"))
        live = _read_json(os.path.join(control, "codes_histogram.json"))["live_codes"]
        history = _read_json(os.path.join(control, "prior_history.json"))["val_loss"]
        payload["control"] = {"dir": os.path.basename(os.path.normpath(control)), "wall_times": wall,
                              "rows": [live_codes_row(live)] + control_rows(history, jax_history)}
    judged = [r["pass"] for part in ("run", "control") if payload[part]
              for r in payload[part]["rows"] if r["pass"] is not None]
    payload["all_pass"] = bool(judged) and all(judged)
    _print_table(payload)
    if json_out:
        os.makedirs(os.path.dirname(json_out) or ".", exist_ok=True)
        with open(json_out, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {json_out}")
    return payload


def _print_table(payload: dict) -> None:
    print("| run | rule | port | JAX | pass |")
    print("| --- | --- | --- | --- | --- |")
    for part in ("run", "control"):
        if payload[part] is None:
            continue
        for r in payload[part]["rows"]:
            verdict = "recorded" if r["pass"] is None else ("**pass**" if r["pass"] else "**FAIL**")
            print(f"| {part} | {r['rule']} | {json.dumps(r['port'])} | {json.dumps(r['jax'])} | {verdict} |")
        wall = payload[part]["wall_times"]
        print(f"{part}: {wall.get('device')}, total {wall.get('total_s')} s, "
              f"{', '.join(f'{k} {wall[k]:.1f} s' for k in WALL_KEYS.values() if k in wall)}")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["stage"]:
        return stage(argv[1:])
    ap = argparse.ArgumentParser(prog="python -m vqvae_tpu_torch.bench.e2e")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("run", help="the four stages at the reference's scale into --out")
    pr.add_argument("--out", type=str, required=True)
    pr.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--n_updates", type=int, default=5000)
    pr.add_argument("--epochs", type=int, default=100,
                    help="train-prior's --epochs (epochs 1 .. epochs - 1 run, as in the reference)")
    pr.add_argument("--n_samples", type=int, default=100)
    pc = sub.add_parser("prior-control", help="the prior on the JAX run's own latents into --out")
    pc.add_argument("--out", type=str, required=True)
    pc.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    pc.add_argument("--seed", type=int, default=0)
    pp = sub.add_parser("report", help="the runs against the JAX run's records")
    pp.add_argument("--out", type=str, required=True)
    pp.add_argument("--control", type=str, default=None)
    pp.add_argument("--json", type=str, default=None, help="write the payload here (none by default)")
    args = ap.parse_args(argv)
    if args.cmd == "run":
        return run(args.out, args.device, args.seed, args.n_updates, args.epochs, args.n_samples)
    if args.cmd == "prior-control":
        return prior_control(args.out, args.device, args.seed)
    return 0 if report(args.out, args.control, args.json)["all_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
