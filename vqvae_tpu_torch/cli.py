"""Command-line interface of the port (counterpart of ``vqvae_tpu/cli.py``).

    python -m vqvae_tpu_torch.cli extract-latents --checkpoint results/...npz [--device cpu]

The model is rebuilt from the checkpoint's stored hyperparameters. Runs on
the CUDA card unless ``--device cpu`` is given. The other subcommands come
with later slices.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def cmd_extract_latents(args) -> int:
    from vqvae_tpu_torch.data.datasets import load_dataset
    from vqvae_tpu_torch.pipelines.extract import extract_latents
    from vqvae_tpu_torch.pipelines.viz import load_model

    model, _metrics, _hp = load_model(args.checkpoint, device=args.device)
    train_ds, val_ds, _var, _info = load_dataset(args.dataset, args.data_dir)
    out = args.out or f"{args.data_dir}/latent_e_indices.npy"
    data = np.concatenate([train_ds.data, val_ds.data])
    codes = extract_latents(model, data, batch_size=args.extract_batch, out_path=out)
    print(f"Saved {codes.shape} code grids from {args.checkpoint} to {out}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vqvae_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    ex = sub.add_parser("extract-latents", help="dataset -> code indices .npy")
    ex.add_argument("--checkpoint", type=str, required=True)
    ex.add_argument("--out", type=str, default=None)
    ex.add_argument("--extract_batch", type=int, default=256)
    ex.add_argument("--dataset", type=str, default="CIFAR10")
    ex.add_argument("--data_dir", type=str, default="data")
    ex.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    ex.set_defaults(fn=cmd_extract_latents)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
