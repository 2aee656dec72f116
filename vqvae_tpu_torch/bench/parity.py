"""5,000-update convergence fleets of the port on the card, judged against the
reference's and the JAX package's fleets (counterpart of
``tools/parity_5k.py``'s ``jax`` and ``report`` subcommands and of
``tools/run_precision_fleet.sh``).

    python -m vqvae_tpu_torch.bench.parity run --seed 1 --out D/port_5k_seed1.npz [mode flags] [--device cpu]
    python -m vqvae_tpu_torch.bench.parity fleet --out_dir D [--jobs 4] [--modes fp32 bf16 ema ema_bf16 high]
    python -m vqvae_tpu_torch.bench.parity report [--port_dir artifacts_torch] [--ref_dir artifacts] [--json F]
    python -m vqvae_tpu_torch.bench.parity compare A.npz B.npz

``run`` trains the reference's VQ-VAE with the JAX tool's configuration
(``share_residual_weights=True``, batch 32, 5,000 updates in chunks of 50,
the synthetic CIFAR-10 set that is bit-identical to the JAX one) from the
port's own initial weights for ``--seed``, and writes the per-update curves
with the JAX tool's keys, so that ``tools/parity_5k.py::_final_window`` reads
the file as it is. The JAX PRNG is not reproduced: the comparison is between
seed distributions, as ``PARITY.md``'s is.

``fleet`` runs the pre-registered ``FLEETS``, each run its own process of
``run`` (the shell script ran one process a run), up to ``--jobs`` at once on
the one card: a step at batch 32 leaves it mostly idle, and a run's curves do
not depend on what runs beside it (train steps repeat bit for bit; ``compare``
checks two files). The kernels are built once before the first run starts.
When a run ends, the fleet writes into its file ``concurrent_runs``: the most
runs it had on the card at once while that run lived (a file written by
``run`` alone has no such key). A file that exists is skipped; a failed run
is printed with its error, the fleet goes on and then exits non-zero.

Inclusion rule, fixed before the first fleet ran: every launched seed is
committed and counted; no run is dropped or re-run for its result; a run cut
by a time limit leaves no file (``run`` writes its file whole at the end), is
launched again whole, and the cut is recorded.

``report`` gives, per mode and for recon, total loss and perplexity over the
final ``WINDOW`` updates, the JAX report's ``_metric_verdict`` against the
reference fleet (``reference_5k_seed*.npz`` + ``reference_5k_torchinit.npz``,
n = 79: the north star) and against the JAX fleet of the same mode (the
port's fidelity to the JAX package), and the JAX report's ``ok`` rule for
each. The EMA modes train the codebook by another rule than the reference,
so against it they get, as in the JAX report's mode ladder, a recon verdict
and the other two as plain means, and no ``ok``: their fidelity verdict is
the one against the JAX fleet. Beside the verdicts, ``embedding_loss``
splits total loss: total loss minus recon, the codebook and commitment
terms, judged the same way (the EMA modes against JAX only) and left out of
``ok``. It reads ``--ref_dir`` only, prints one table and writes one JSON
only where ``--json`` names a file. No subcommand writes into the JAX
package's ``artifacts/``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from vqvae_tpu_torch.bench.timing import device_line
from vqvae_tpu_torch.config import TrainConfig, VQVAEConfig
from vqvae_tpu_torch.data.datasets import load_dataset
from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.ops import cuda_quantizer
from vqvae_tpu_torch.train.vqvae_train import train_vqvae

WINDOW = 100  # final-window size for the convergence comparison
STEPS = 5000
BATCH_SIZE = 32
RUN_TIMEOUT_S = 900  # a run's limit in a fleet, the shell script's
CURVES = ("recon_errors", "loss_vals", "perplexities")
# (file key, report name, lower is better)
METRICS = (("recon_errors", "recon", True), ("loss_vals", "total_loss", True),
           ("perplexities", "perplexity", False))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
JAX_RECORDS = os.path.join(ROOT, "artifacts")


class Fleet(NamedTuple):
    mode: str
    seeds: Tuple[int, ...]
    flags: Tuple[str, ...]   # ``run``'s flags, the JAX fleet's


BF16_FLAGS = ("--compute_dtype", "bfloat16", "--conv_precision", "default", "--quantizer_precision", "default")
# Pre-registered before the first fleet ran, in the order they run; fp32's
# seeds 21-40 were registered after its first 20 had run, before they ran.
# Search route on the card under "auto" at the fleets' 2,048 rows: fp32 and
# ema the matmul branch (the "highest" search; "fma" before the measured
# dispatch), high and bf16 and ema_bf16 "mma" ("high" and "default"). Each
# run's file records the route it took (``search``).
FLEETS = (
    Fleet("fp32", tuple(range(1, 41)), ()),
    Fleet("bf16", tuple(range(1, 21)), BF16_FLAGS),
    Fleet("ema", (1, 2, 3), ("--ema",)),
    Fleet("ema_bf16", (1, 2, 3), ("--ema",) + BF16_FLAGS),
    Fleet("high", tuple(range(1, 21)), ("--conv_precision", "high")),
)
MODES = tuple(f.mode for f in FLEETS)
# another codebook rule than the reference's: judged against it on recon only
EMA_MODES = ("ema", "ema_bf16")
# the JAX fleet of each mode in --ref_dir (fp32: ``_seed_runs``)
_JAX_MODE_GLOBS = {"high": "jax_5k_high_seed*.npz", "bf16": "jax_5k_bf16_seed*.npz",
                   "ema": "jax_5k_ema_seed*.npz", "ema_bf16": "jax_5k_ema_bf16_seed*.npz"}
CRITERION = (
    "per metric: 'pass' if the one-sided 95% Welch upper confidence "
    "bound on the adverse relative means-difference is < +1% (the "
    "BASELINE.md north star, certified); 'no_detectable_bias' if the "
    "two-sided 95% CI contains 0 AND |diff of means| < the baseline fleet's own "
    "relative seed std (the two differ by less than the baseline differs "
    "from itself); else 'bias_detected'. Overall ok = recon in "
    "{pass, no_detectable_bias} and no secondary metric shows "
    "bias_detected. Each verdict holds the port's fleet (the fields "
    "jax_*, the JAX tool's names) against a baseline fleet (the fields "
    "torch_*): the reference's (vs_reference) or the JAX package's of the "
    "same mode (vs_jax). The EMA modes get against the reference a recon "
    "verdict and plain means (their codebook rule is not the reference's), "
    "and no ok. embedding_loss = total_loss - recon is a diagnostic, judged "
    "the same way and outside ok. Final-window means over the last 100 "
    "updates of each run."
)


def port_file(mode: str, seed: int) -> str:
    return f"port_5k_seed{seed}.npz" if mode == "fp32" else f"port_5k_{mode}_seed{seed}.npz"


def _refuse_jax_records(path: str) -> None:
    """The JAX package's records are read, never written."""
    real, records = os.path.realpath(path), os.path.realpath(JAX_RECORDS)
    if real == records or real.startswith(records + os.sep):
        raise ValueError(f"{path} lies in the JAX package's artifacts/, which the port does not write")


# -- run ---------------------------------------------------------------------


def run(
    steps: int,
    out: str,
    batch_size: int,
    seed: int,
    conv_precision: str = "highest",
    compute_dtype: str = "float32",
    quantizer_precision: str = "highest",
    ema_codebook: bool = False,
    device: str = "cuda",
) -> None:
    """One run of ``steps`` updates into ``out`` (the JAX ``run_jax``)."""
    _refuse_jax_records(out)
    dev = resolve_device(device)
    vq_cfg = VQVAEConfig(
        share_residual_weights=True,
        conv_precision=conv_precision,
        compute_dtype=compute_dtype,
        quantizer_precision=quantizer_precision,
        ema_codebook=ema_codebook,
    )
    train_cfg = TrainConfig(
        batch_size=batch_size,
        n_updates=steps,
        seed=seed,
        save=False,
        steps_per_dispatch=50,
    )
    dataset = load_dataset("CIFAR10", "data")
    card = device_line(dev)
    print(f"device={card} dataset={dataset[3]}", flush=True)
    before = dict(cuda_quantizer.launches_by_route)
    t0 = time.time()
    _state, history, _trainer = train_vqvae(vq_cfg, train_cfg, dataset=dataset, device=device)
    dt = time.time() - t0
    launched = [r for r in cuda_quantizer.ROUTES if cuda_quantizer.launches_by_route[r] > before[r]]
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    # written whole or not at all: a cut run leaves no file behind
    tmp = f"{out}.partial"
    with open(tmp, "wb") as fh:
        np.savez_compressed(
            fh,
            recon_errors=np.asarray(history.recon_errors, np.float32),
            loss_vals=np.asarray(history.loss_vals, np.float32),
            perplexities=np.asarray(history.perplexities, np.float32),
            x_train_var=dataset[2],
            device=card,
            wall_seconds=dt,
            conv_precision=conv_precision,
            compute_dtype=compute_dtype,
            quantizer_precision=quantizer_precision,
            ema_codebook=ema_codebook,
            search=search_route(dev.type, launched),
        )
    os.replace(tmp, out)
    print(f"saved {out} ({steps} steps in {dt:.0f}s)", flush=True)


def search_route(device_type: str, launched: List[str]) -> str:
    """The route a run's searches took: the kernels it launched, the matmul
    branch on a card where it launched none, the plain version on the CPU."""
    if device_type != "cuda":
        return "plain"
    return "+".join(launched) or "matmul"


# -- fleet -------------------------------------------------------------------


def plan(out_dir: str, modes=MODES) -> Tuple[List[tuple], List[str]]:
    """The fleets' runs in order: ((fleet, seed, path) still to run, paths
    that exist and are skipped)."""
    todo, skipped = [], []
    for f in FLEETS:
        if f.mode not in modes:
            continue
        for seed in f.seeds:
            path = os.path.join(out_dir, port_file(f.mode, seed))
            if os.path.exists(path):
                skipped.append(path)
            else:
                todo.append((f, seed, path))
    return todo, skipped


def _run_argv(f: Fleet, seed: int, path: str, device: str) -> list:
    return [sys.executable, "-m", "vqvae_tpu_torch.bench.parity", "run", "--steps", str(STEPS),
            "--seed", str(seed), "--out", path, "--device", device, *f.flags]


def _record_concurrency(path: str, concurrent_runs: int) -> None:
    """Add ``concurrent_runs`` to a finished run's file, whole or not at all."""
    with np.load(path) as d:
        fields = {key: d[key] for key in d.files}
    tmp = f"{path}.partial"
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **fields, concurrent_runs=concurrent_runs)
    os.replace(tmp, path)


def fleet(out_dir: str, modes=MODES, jobs: int = 1, device: str = "cuda") -> int:
    """Run the fleets' missing files, up to ``jobs`` processes at once; 0 when
    every launched run wrote its file."""
    _refuse_jax_records(out_dir)
    unknown = set(modes) - set(MODES)
    if unknown:
        raise ValueError(f"unknown modes {sorted(unknown)}; the fleets are {', '.join(MODES)}")
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    todo, skipped = plan(out_dir, modes)
    for path in skipped:
        print(f"skip {path} (exists)", flush=True)
    if todo and dev.type == "cuda":
        from vqvae_tpu_torch.ops import cuda_quantizer

        # once, here: concurrent first builds would race on build/kernels/
        print(f"kernels: {cuda_quantizer.build()}", flush=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    pending, running, failed = list(todo), [], []
    t_fleet = time.time()
    try:
        while pending or running:
            while pending and len(running) < max(1, jobs):
                f, seed, path = pending.pop(0)
                argv = _run_argv(f, seed, path, device)
                print(f"=== {time.strftime('%H:%M:%S')} {f.mode} seed={seed} -> {path} {' '.join(f.flags)}",
                      flush=True)
                log = tempfile.TemporaryFile(mode="w+")
                proc = subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT, env=env)
                running.append([proc, log, path, time.time(), 0])
            for item in running:  # the most runs on the card while each lived
                item[4] = max(item[4], len(running))
            time.sleep(0.2)
            for item in list(running):
                proc, log, path, t0, most = item
                if proc.poll() is None and time.time() - t0 < RUN_TIMEOUT_S:
                    continue
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                running.remove(item)
                log.seek(0)
                text = log.read()
                log.close()
                if proc.returncode == 0 and os.path.exists(path):
                    _record_concurrency(path, most)
                    print(f"done {path} in {time.time() - t0:.1f} s beside at most {most - 1} others: "
                          f"{text.strip().splitlines()[-1]}", flush=True)
                else:
                    failed.append(path)
                    print(f"FAILED {path} rc={proc.returncode} after {time.time() - t0:.1f} s:\n"
                          f"{text[-3000:]}", flush=True)
    finally:  # an interrupted fleet leaves no run behind
        for proc, log, *_rest in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    print(f"=== fleet done in {time.time() - t_fleet:.1f} s: {len(todo) - len(failed)} written, "
          f"{len(skipped)} skipped, {len(failed)} failed {failed}", flush=True)
    return 1 if failed else 0


# -- report ------------------------------------------------------------------


def _final_window(path: str, key: str = "recon_errors") -> float:
    d = np.load(path)
    c = d[key]
    return float(np.mean(c[-min(WINDOW, len(c)) :]))


def _seed_runs(art_dir: str):
    """The committed reference and JAX fp32 5k curves (seeded files + the
    unseeded one of each side), in the JAX report's order."""
    torch_paths = sorted(
        glob.glob(os.path.join(art_dir, "reference_5k_seed*.npz"))
    ) + [os.path.join(art_dir, "reference_5k_torchinit.npz")]
    jax_paths = sorted(glob.glob(os.path.join(art_dir, "jax_5k_seed*.npz"))) + [
        os.path.join(art_dir, "jax_5k.npz")
    ]
    torch_paths = [p for p in torch_paths if os.path.exists(p)]
    jax_paths = [p for p in jax_paths if os.path.exists(p)]
    return torch_paths, jax_paths


def _mode_fleets(art_dir: str):
    """The JAX package's committed fleets of the other modes: mode -> sorted paths."""
    fleets = {}
    for mode, pat in _JAX_MODE_GLOBS.items():
        paths = sorted(glob.glob(os.path.join(art_dir, pat)))
        if paths:
            fleets[mode] = paths
    return fleets


def _port_fleets(port_dir: str):
    """The port's files by mode: mode -> sorted paths."""
    fleets = {}
    for mode in MODES:
        pat = "port_5k_seed*.npz" if mode == "fp32" else f"port_5k_{mode}_seed*.npz"
        paths = sorted(glob.glob(os.path.join(port_dir, pat)))
        if paths:
            fleets[mode] = paths
    return fleets


def _seed_of(path: str) -> Optional[int]:
    m = re.search(r"seed(\d+)\.npz$", os.path.basename(path))
    return int(m.group(1)) if m else None


def _seed_span(paths) -> str:
    """Human-readable span of seed numbers in a fleet, flagging gaps."""
    seeds = sorted(s for s in map(_seed_of, paths) if s is not None)
    if not seeds:
        return "none"
    span = f"{seeds[0]}-{seeds[-1]}"
    missing = sorted(set(range(seeds[0], seeds[-1] + 1)) - set(seeds))
    if not missing:
        return f"{span} (contiguous, n={len(seeds)})"
    return f"{span} missing {missing} (n={len(seeds)})"


def _metric_verdict(torch_finals, jax_finals, lower_is_better=True):
    """Seed-distribution comparison with a decidable, non-gameable criterion
    (the JAX report's arithmetic, copied; ``torch_*`` is the baseline fleet,
    ``jax_*`` the fleet judged).

    - "pass":   one-sided 95% upper confidence bound (Welch-Satterthwaite df)
                on the relative means-difference (jax - torch)/torch is below
                +1% — certified no worse than the baseline + 1%.
    - "no_detectable_bias": the two-sided 95% CI contains 0 AND the point
                estimate |dev| is smaller than the baseline's OWN relative
                seed std. NOT a certificate of <1%.
    - "bias_detected": otherwise.

    For perplexity higher is better; the non-inferiority direction flips.
    """
    from scipy import stats as sps

    nt, nj = len(torch_finals), len(jax_finals)
    t_mean, j_mean = float(np.mean(torch_finals)), float(np.mean(jax_finals))
    t_var = float(np.var(torch_finals, ddof=1)) if nt > 1 else 0.0
    j_var = float(np.var(jax_finals, ddof=1)) if nj > 1 else 0.0
    se = (t_var / nt + j_var / nj) ** 0.5
    # Welch-Satterthwaite degrees of freedom
    if se > 0 and nt > 1 and nj > 1:
        df = (t_var / nt + j_var / nj) ** 2 / (
            (t_var / nt) ** 2 / (nt - 1) + (j_var / nj) ** 2 / (nj - 1)
        )
    else:
        df = max(nt + nj - 2, 1)
    tcrit95 = float(sps.t.ppf(0.95, df)) if se > 0 else 0.0
    diff_rel = (j_mean - t_mean) / t_mean
    se_rel = se / abs(t_mean)
    welch_t = (j_mean - t_mean) / se if se > 0 else 0.0
    # adverse direction: higher is worse for losses, lower is worse for perplexity
    if lower_is_better:
        adverse_bound = diff_rel + tcrit95 * se_rel   # upper bound
    else:
        adverse_bound = -(diff_rel - tcrit95 * se_rel)  # -(lower bound)
    tcrit975 = float(sps.t.ppf(0.975, df)) if se > 0 else 0.0
    ci95 = (diff_rel - tcrit975 * se_rel, diff_rel + tcrit975 * se_rel)
    t_rel_std = (t_var**0.5) / abs(t_mean) if t_mean else 0.0
    pooled_rel_std = ((t_var + j_var) / 2) ** 0.5 / abs(t_mean)
    # runs/side for a 1% one-sided non-inferiority certificate at ~80% power
    n_needed = (
        int(np.ceil(2 * ((1.645 + 0.84) * pooled_rel_std / 0.01) ** 2))
        if pooled_rel_std > 0
        else None
    )
    if adverse_bound < 0.01:
        verdict = "pass"
    elif ci95[0] <= 0.0 <= ci95[1] and abs(diff_rel) < t_rel_std:
        verdict = "no_detectable_bias"
    else:
        verdict = "bias_detected"
    return {
        "n_torch": nt,
        "n_jax": nj,
        "torch_mean": t_mean,
        "jax_mean": j_mean,
        "torch_rel_std": t_rel_std,
        "jax_rel_std": (j_var**0.5) / abs(j_mean) if j_mean else 0.0,
        "torch_band": [float(min(torch_finals)), float(max(torch_finals))],
        "jax_band": [float(min(jax_finals)), float(max(jax_finals))],
        "rel_diff_of_means": diff_rel,
        "welch_t": welch_t,
        "welch_df": float(df),
        "ci95_rel_diff": [float(ci95[0]), float(ci95[1])],
        "adverse_bound_95": float(adverse_bound),
        "jax_mean_in_torch_band": bool(
            min(torch_finals) <= j_mean <= max(torch_finals)
        ),
        "runs_per_side_for_1pct_certificate": n_needed,
        "verdict": verdict,
    }


def _ok(verdicts: dict) -> bool:
    """The JAX report's overall rule."""
    return bool(
        verdicts["recon"]["verdict"] in ("pass", "no_detectable_bias")
        and verdicts["total_loss"]["verdict"] != "bias_detected"
        and verdicts["perplexity"]["verdict"] != "bias_detected"
    )


def _finals(path: str) -> dict:
    """A run's final-window means by report name, with ``embedding_loss``:
    total loss minus recon, the codebook and commitment terms."""
    out = {name: _final_window(path, key) for key, name, _ in METRICS}
    out["embedding_loss"] = out["total_loss"] - out["recon"]
    return out


_LOWER_IS_BETTER = {**{name: lower for _key, name, lower in METRICS}, "embedding_loss": True}


def _verdicts(baseline: List[dict], port: List[dict], names) -> dict:
    return {name: _metric_verdict([b[name] for b in baseline], [p[name] for p in port],
                                  lower_is_better=_LOWER_IS_BETTER[name]) for name in names}


def _run_row(mode: str, path: str) -> dict:
    with np.load(path) as d:
        def field(key, cast):
            return cast(d[key]) if key in d else None

        row = {"mode": mode, "seed": _seed_of(path), "file": os.path.basename(path),
               "steps": int(len(d["recon_errors"]))}
        row.update(_finals(path))
        row.update(wall_seconds=field("wall_seconds", float), concurrent_runs=field("concurrent_runs", int),
                   device=field("device", str), quantizer_precision=field("quantizer_precision", str),
                   search=field("search", str))
    return row


def report(port_dir: str, ref_dir: str = "artifacts", json_out: Optional[str] = None) -> dict:
    """Verdicts of the port's fleets in ``port_dir`` against the reference's
    and the JAX package's in ``ref_dir`` (read only); the payload, also
    written to ``json_out`` where one is given."""
    if json_out:
        _refuse_jax_records(json_out)
    ref_paths, jax_fp32 = _seed_runs(ref_dir)
    ref = [_finals(p) for p in ref_paths]
    jax_fleets = {mode: [_finals(p) for p in paths]
                  for mode, paths in {"fp32": jax_fp32, **_mode_fleets(ref_dir)}.items() if paths}
    names = [name for _key, name, _lower in METRICS]
    judged = names + ["embedding_loss"]
    runs, modes = [], {}
    for mode, paths in _port_fleets(port_dir).items():
        rows = [_run_row(mode, p) for p in paths]
        runs += rows
        walls = [r["wall_seconds"] for r in rows if r["wall_seconds"] is not None]
        precision = rows[0]["quantizer_precision"] or "highest"
        jax = jax_fleets.get(mode)
        vs_ref = _verdicts(ref, rows, judged)
        vs_jax = _verdicts(jax, rows, judged) if jax else None
        split = {"vs_reference": vs_ref.pop("embedding_loss"),
                 "vs_jax": vs_jax.pop("embedding_loss") if jax else None}
        if mode in EMA_MODES:  # the JAX report's mode ladder: recon judged, the others means
            vs_ref = {"recon": vs_ref["recon"], **{f"{n}_mean": vs_ref[n]["jax_mean"] for n in names[1:]}}
            split["vs_reference"] = None
        modes[mode] = {
            "n": len(paths),
            "seeds": _seed_span(paths),
            # a file without ``search`` predates the matmul branch: its
            # searches all launched the kernel of its mode
            "route": "+".join(sorted({r["search"] or cuda_quantizer.kernel_route(
                precision, VQVAEConfig().embedding_dim) for r in rows})),
            "mean_wall_seconds": float(np.mean(walls)) if walls else None,
            "vs_reference": vs_ref,
            "vs_jax": vs_jax,
            "embedding_loss": split,
            "ok": {"vs_reference": None if mode in EMA_MODES else _ok(vs_ref),
                   "vs_jax": _ok(vs_jax) if jax else None},
        }
    payload = {"criterion": CRITERION, "window": WINDOW, "port_dir": port_dir, "ref_dir": ref_dir,
               "runs": runs, "modes": modes}
    _print_table(payload)
    if json_out:
        os.makedirs(os.path.dirname(json_out) or ".", exist_ok=True)
        with open(json_out, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {json_out}")
    return payload


def _print_table(payload: dict) -> None:
    def side(m):
        if m is None:
            return "— | — | — | — | —"
        return (f"{m['torch_mean']:.4f} (n={m['n_torch']}) | {m['rel_diff_of_means']:+.2%} | "
                f"[{m['ci95_rel_diff'][0]:+.2%}, {m['ci95_rel_diff'][1]:+.2%}] | "
                f"{m['adverse_bound_95']:+.2%} | **{m['verdict']}**")

    print("| mode | metric | port mean (n, rel std) | reference mean (n) | diff | 95% CI | adverse bound | "
          "verdict | JAX mean (n) | diff | 95% CI | adverse bound | verdict |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|---|")
    for mode, e in payload["modes"].items():
        for name in [name for _key, name, _ in METRICS] + ["embedding_loss"]:
            if name == "embedding_loss":
                ref, jax = e["embedding_loss"]["vs_reference"], e["embedding_loss"]["vs_jax"]
            else:
                ref = e["vs_reference"].get(name)
                jax = e["vs_jax"][name] if e["vs_jax"] else None
            port = [r[name] for r in payload["runs"] if r["mode"] == mode]
            rel_std = np.std(port, ddof=1) / abs(np.mean(port)) if len(port) > 1 else 0.0
            ref_cell = side(ref) if ref else "— | — | — | — | descriptive"
            print(f"| {mode} | {name} | {np.mean(port):.4f} (n={len(port)}, {rel_std:.1%}) | "
                  f"{ref_cell} | {side(jax)} |")
    for mode, e in payload["modes"].items():
        print(f"{mode}: seeds {e['seeds']}, route {e['route']}, ok vs reference {e['ok']['vs_reference']}, "
              f"ok vs JAX {e['ok']['vs_jax']}, mean wall {e['mean_wall_seconds']} s")


# -- compare -----------------------------------------------------------------


def compare(path_a: str, path_b: str) -> dict:
    """Whether two runs' curves are the same bits, and their largest gaps."""
    with np.load(path_a) as a, np.load(path_b) as b:
        gaps = {key: float(np.max(np.abs(a[key].astype(np.float64) - b[key].astype(np.float64))))
                for key in CURVES}
        same = all(np.array_equal(a[key], b[key]) for key in CURVES)
    return {"same": same, "max_abs_diff": gaps, "a": path_a, "b": path_b}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vqvae_tpu_torch.bench.parity")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("run", help="one run into --out")
    pr.add_argument("--steps", type=int, default=STEPS)
    pr.add_argument("--batch_size", type=int, default=BATCH_SIZE)
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--out", type=str, required=True)
    pr.add_argument("--conv_precision", type=str, default="highest")
    pr.add_argument("--compute_dtype", type=str, default="float32")
    pr.add_argument("--quantizer_precision", type=str, default="highest")
    pr.add_argument("--ema", action="store_true", help="EMA codebook updates")
    pr.add_argument("--device", type=str, default="cuda")
    pf = sub.add_parser("fleet", help="the pre-registered fleets into --out_dir")
    pf.add_argument("--out_dir", type=str, required=True)
    pf.add_argument("--modes", nargs="+", default=list(MODES), choices=MODES)
    pf.add_argument("--jobs", type=int, default=1, help="runs at once on the card")
    pf.add_argument("--device", type=str, default="cuda")
    pp = sub.add_parser("report", help="verdicts against the reference and JAX fleets")
    pp.add_argument("--port_dir", type=str, default="artifacts_torch")
    pp.add_argument("--ref_dir", type=str, default="artifacts", help="the JAX package's records, read only")
    pp.add_argument("--json", type=str, default=None, help="write the payload here (none by default)")
    pc = sub.add_parser("compare", help="are two runs' curves the same bits")
    pc.add_argument("a")
    pc.add_argument("b")
    args = ap.parse_args(argv)
    if args.cmd == "run":
        run(args.steps, args.out, args.batch_size, args.seed, conv_precision=args.conv_precision,
            compute_dtype=args.compute_dtype, quantizer_precision=args.quantizer_precision,
            ema_codebook=args.ema, device=args.device)
        return 0
    if args.cmd == "fleet":
        return fleet(args.out_dir, args.modes, args.jobs, args.device)
    if args.cmd == "compare":
        out = compare(args.a, args.b)
        print(json.dumps(out))
        return 0 if out["same"] else 1
    payload = report(args.port_dir, args.ref_dir, args.json)
    return 0 if all(False not in e["ok"].values() for e in payload["modes"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
