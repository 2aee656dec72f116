"""Command-line interface of the port (counterpart of ``vqvae_tpu/cli.py``).

    python -m vqvae_tpu_torch.cli train-vqvae [--batch_size 32 --n_updates 5000 ...] [--device cpu]
    python -m vqvae_tpu_torch.cli extract-latents --checkpoint results/...npz [--device cpu]

Flag names and defaults of ``train-vqvae`` are the JAX package's (and the
reference's, main.py:16-30), without the mesh flags. ``extract-latents``
rebuilds the model from the checkpoint's stored hyperparameters. Both run on
the CUDA card unless ``--device cpu`` is given. The other subcommands come
with later slices.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _add_vqvae_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--n_updates", type=int, default=5000)
    p.add_argument("--n_hiddens", type=int, default=128)
    p.add_argument("--n_residual_hiddens", type=int, default=32)
    p.add_argument("--n_residual_layers", type=int, default=2)
    p.add_argument("--embedding_dim", type=int, default=64)
    p.add_argument("--n_embeddings", type=int, default=512)
    p.add_argument("--beta", type=float, default=0.25)
    p.add_argument("--learning_rate", type=float, default=3e-4)
    p.add_argument("--log_interval", type=int, default=50)
    p.add_argument("--dataset", type=str, default="CIFAR10")
    p.add_argument("-save", action="store_true")
    p.add_argument("--filename", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--share_residual_weights", action="store_true",
                   help="strict parity with the reference's accidental weight sharing")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint for this filename")
    p.add_argument("--amsgrad_impl", type=str, default="torch", choices=["torch", "optax"],
                   help="torch = the reference's optimizer; optax is the JAX package's "
                        "comparison variant, which the port refuses")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="updates per chunk; the metrics are read back once a chunk")
    p.add_argument("--ema_codebook", action="store_true",
                   help="EMA codebook updates instead of gradient descent")
    p.add_argument("--ema_decay", type=float, default=0.99)
    p.add_argument("--quantizer_precision", type=str, default="highest",
                   choices=["highest", "high", "default"],
                   help="distance arithmetic: highest = fp32 on the CUDA cores, "
                        "high/default = bf16 on the tensor cores")
    p.add_argument("--conv_precision", type=str, default="highest",
                   choices=["highest", "high", "default"],
                   help="fp32 conv arithmetic: highest = no TF32 (the reference's "
                        "training arithmetic); moot under --compute_dtype bfloat16")
    p.add_argument("--quantizer_impl", type=str, default="auto",
                   choices=["auto", "pallas", "jnp"],
                   help="stored in the checkpoint for the JAX package; the port "
                        "dispatches on the tensor's device only")


def cmd_train_vqvae(args) -> int:
    from vqvae_tpu_torch.config import TrainConfig, VQVAEConfig
    from vqvae_tpu_torch.train.vqvae_train import train_vqvae

    vq_cfg = VQVAEConfig(
        n_hiddens=args.n_hiddens,
        n_residual_hiddens=args.n_residual_hiddens,
        n_residual_layers=args.n_residual_layers,
        embedding_dim=args.embedding_dim,
        n_embeddings=args.n_embeddings,
        beta=args.beta,
        share_residual_weights=args.share_residual_weights,
        compute_dtype=args.compute_dtype,
        conv_precision=args.conv_precision,
        ema_codebook=args.ema_codebook,
        ema_decay=args.ema_decay,
        quantizer_precision=args.quantizer_precision,
        quantizer_impl=args.quantizer_impl,
    )
    train_cfg = TrainConfig(
        batch_size=args.batch_size,
        n_updates=args.n_updates,
        learning_rate=args.learning_rate,
        log_interval=args.log_interval,
        dataset=args.dataset,
        seed=args.seed,
        save=args.save,
        filename=args.filename,
        data_dir=args.data_dir,
        results_dir=args.results_dir,
        steps_per_dispatch=args.steps_per_dispatch,
        amsgrad_impl=args.amsgrad_impl,
    )
    if args.save:
        name = args.filename or "<timestamp>"
        print(f"Results will be saved in ./{args.results_dir}/vqvae_{name}_step*.npz")
    train_vqvae(vq_cfg, train_cfg, resume=args.resume, device=args.device)
    return 0


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

    tv = sub.add_parser("train-vqvae", help="train the VQ-VAE")
    _add_vqvae_flags(tv)
    tv.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    tv.set_defaults(fn=cmd_train_vqvae)

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
