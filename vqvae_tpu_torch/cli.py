"""Command-line interface of the port (counterpart of ``vqvae_tpu/cli.py``).

    python -m vqvae_tpu_torch.cli train-vqvae [--batch_size 32 --n_updates 5000 ...] [--device cpu]
    python -m vqvae_tpu_torch.cli extract-latents --checkpoint results/...npz [--device cpu]
    python -m vqvae_tpu_torch.cli train-prior [--epochs 100 --batch_size 32 ...] [--device cpu]
    python -m vqvae_tpu_torch.cli sample --vqvae-checkpoint ... --prior-checkpoint ... [--device cpu]
    python -m vqvae_tpu_torch.cli serve --prior-checkpoint ... [--vqvae-checkpoint ...] [--device cpu]
    python -m vqvae_tpu_torch.cli profile [--trace_dir results/trace --profile_steps 10 ...] [--device cpu]
    python -m vqvae_tpu_torch.cli viz --checkpoint results/...npz [--out_dir results/viz] [--device cpu]
    python -m vqvae_tpu_torch.cli benchmark [--iters_lo 20 --iters_hi 120 --repeats 3] [--device cpu]

Flag names and defaults are the JAX package's (and the reference's,
main.py:16-30, gated_pixelcnn.py:27-42). ``train-vqvae`` takes the JAX
command's mesh flags (``--n_data``, ``--n_code``, ``--distributed``,
``--coordinator_address``, ``--num_processes``, ``--process_id``) and
``--dist_backend``; it runs one process a rank (``parallel/distributed.py``).
``train-prior`` takes the same flags but ``--n_code`` (the prior's mesh is
1-D over data). The JAX ``train-prior`` has none of them, because its one
process spreads over every local device by itself; the port runs one
process a rank, and a rank must be told to join a group.
``extract-latents``, ``sample``, ``serve`` and ``viz`` rebuild each model from
its checkpoint's stored hyperparameters; for a file that stores none they
take the model flags, which must then be given (the command fails and names
them otherwise). ``train-prior`` trains on ``<data_dir>/latent_e_indices.npy``
(what ``extract-latents`` writes) and saves ``<results_dir>/latent_block_pixelcnn.npz``.
``benchmark`` prints the port's benchmark line (``vqvae_tpu_torch/bench``,
the counterpart of the JAX command's ``bench.py``) at the model flags' widths.
Every command runs on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


class _ModelFlag(argparse.Action):
    """Stores the value and records that the flag was given, so that a
    checkpoint without stored hyperparameters is refused rather than read
    with default widths nobody asked for."""

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, values)
        namespace.given_model_flags = getattr(namespace, "given_model_flags", frozenset()) | {self.dest}


def _add_vqvae_flags(p: argparse.ArgumentParser) -> None:
    p.set_defaults(given_model_flags=frozenset())
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--n_updates", type=int, default=5000)
    p.add_argument("--n_hiddens", type=int, default=128, action=_ModelFlag)
    p.add_argument("--n_residual_hiddens", type=int, default=32, action=_ModelFlag)
    p.add_argument("--n_residual_layers", type=int, default=2, action=_ModelFlag)
    p.add_argument("--embedding_dim", type=int, default=64, action=_ModelFlag)
    p.add_argument("--n_embeddings", type=int, default=512, action=_ModelFlag)
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
                   help="the search's forward on the card: pallas the hand-written kernel, "
                        "jnp the matmul branch (cuBLAS + argmin), auto the one measured "
                        "faster at the shape; a loaded checkpoint searches as this flag "
                        "says, whatever it stores")


def _add_mesh_flags(p: argparse.ArgumentParser, code_axis: bool = True) -> None:
    p.add_argument("--n_data", type=int, default=None,
                   help="ranks on the data axis (default: world size // n_code)")
    if code_axis:
        p.add_argument("--n_code", type=int, default=1,
                       help="ranks that share the codebook row-wise")
    p.add_argument("--distributed", action="store_true",
                   help="join a torch.distributed group: one process a rank")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of rank 0 (default: the env:// variables of a launcher)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                   help="default: nccl on CUDA ranks, gloo on the CPU; gloo where ranks "
                        "share one card")


def _mesh_cfg(args):
    from vqvae_tpu_torch.config import MeshConfig

    return MeshConfig(
        n_data=args.n_data,
        n_code=getattr(args, "n_code", 1),
        distributed=args.distributed,
        coordinator_address=args.coordinator_address,
        num_processes=args.num_processes,
        process_id=args.process_id,
        backend=args.dist_backend,
    )


def _add_prior_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--img_dim", type=int, default=8, action=_ModelFlag)
    p.add_argument("--n_layers", type=int, default=15, action=_ModelFlag)


def _given(flags, args) -> bool:
    return any(f.lstrip("-") in args.given_model_flags for f in flags)


def _vqvae_cfg_from_flags(args):
    """The VQ-VAE config of the model and mode flags (``train-vqvae``, ``profile``)."""
    from vqvae_tpu_torch.config import VQVAEConfig

    return VQVAEConfig(
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


def _vqvae_flags_cfg(args):
    """The VQ-VAE config the model flags give: the fallback for a checkpoint
    that stores no hyperparameters (``load_model`` prefers stored ones).
    None when no model flag was given, so that such a file is refused."""
    from vqvae_tpu_torch.pipelines.viz import VQVAE_FLAGS

    return _vqvae_cfg_from_flags(args) if _given(VQVAE_FLAGS, args) else None


def _prior_flags_cfg(args):
    """The prior config the model flags give (dim = img_dim ** 2, as the
    reference sets it), as ``_vqvae_flags_cfg``."""
    from vqvae_tpu_torch.config import PixelCNNConfig
    from vqvae_tpu_torch.pipelines.viz import PRIOR_FLAGS

    if not _given(PRIOR_FLAGS, args):
        return None
    return PixelCNNConfig(input_dim=args.n_embeddings, dim=args.img_dim ** 2,
                          n_layers=args.n_layers, img_dim=args.img_dim)


def cmd_train_vqvae(args) -> int:
    from vqvae_tpu_torch.config import TrainConfig
    from vqvae_tpu_torch.parallel.distributed import (
        is_primary_host,
        maybe_initialize_distributed,
        shutdown_distributed,
    )
    from vqvae_tpu_torch.train.vqvae_train import train_vqvae

    vq_cfg = _vqvae_cfg_from_flags(args)
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
    mesh_cfg = _mesh_cfg(args)
    device = maybe_initialize_distributed(mesh_cfg, args.device)
    try:
        if args.save and is_primary_host():
            name = args.filename or "<timestamp>"
            print(f"Results will be saved in ./{args.results_dir}/vqvae_{name}_step*.npz")
        train_vqvae(vq_cfg, train_cfg, mesh_cfg, resume=args.resume, device=device)
    finally:
        shutdown_distributed()
    return 0


def cmd_extract_latents(args) -> int:
    from vqvae_tpu_torch.data.datasets import load_dataset
    from vqvae_tpu_torch.pipelines.extract import extract_latents
    from vqvae_tpu_torch.pipelines.viz import load_model

    model, _metrics, _hp = load_model(args.checkpoint, device=args.device,
                                      fallback_cfg=_vqvae_flags_cfg(args),
                                      quantizer_impl=args.quantizer_impl)
    train_ds, val_ds, _var, _info = load_dataset(args.dataset, args.data_dir)
    out = args.out or f"{args.data_dir}/latent_e_indices.npy"
    data = np.concatenate([train_ds.data, val_ds.data])
    codes = extract_latents(model, data, batch_size=args.extract_batch, out_path=out)
    print(f"Saved {codes.shape} code grids from {args.checkpoint} to {out}")
    return 0


def cmd_train_prior(args) -> int:
    import os

    from vqvae_tpu_torch.config import PixelCNNConfig, TrainConfig
    from vqvae_tpu_torch.data.datasets import load_dataset
    from vqvae_tpu_torch.parallel.distributed import maybe_initialize_distributed, shutdown_distributed
    from vqvae_tpu_torch.train.pixelcnn_train import train_pixelcnn

    mesh_cfg = _mesh_cfg(args)
    # refuses a missing card before the data is read
    device = maybe_initialize_distributed(mesh_cfg, args.device)
    train_ds, val_ds, _var, _info = load_dataset("LATENT_BLOCK", args.data_dir)
    cfg = PixelCNNConfig(
        input_dim=args.n_embeddings,
        dim=args.img_dim ** 2,
        n_layers=args.n_layers,
        img_dim=args.img_dim,
        compute_dtype=args.compute_dtype,
        conv_precision=args.conv_precision,
    )
    train_cfg = TrainConfig(
        batch_size=args.batch_size,
        epochs=args.epochs,
        learning_rate=args.learning_rate,
        log_interval=args.log_interval,
        save=args.save,
        data_dir=args.data_dir,
        results_dir=args.results_dir,
        seed=args.seed,
        gen_samples=args.gen_samples,
        steps_per_dispatch=args.steps_per_dispatch,
    )
    save_path = os.path.join(args.results_dir, "latent_block_pixelcnn.npz")
    try:
        train_pixelcnn(cfg, train_cfg, train_ds, val_ds, save_path=save_path, resume=args.resume,
                       device=device, mesh_cfg=mesh_cfg)
    finally:
        shutdown_distributed()
    return 0


def cmd_sample(args) -> int:
    import os

    import torch

    from vqvae_tpu_torch.pipelines.sample import sample_images
    from vqvae_tpu_torch.pipelines.viz import load_model, load_prior

    vq_model, _m, _hp = load_model(args.vqvae_checkpoint, device=args.device,
                                   fallback_cfg=_vqvae_flags_cfg(args),
                                   quantizer_impl=args.quantizer_impl)
    prior, _m, _hp = load_prior(args.prior_checkpoint, device=args.device,
                                fallback_cfg=_prior_flags_cfg(args))
    # class-conditional labels cycling 0..9 (the reference draws 10 of each,
    # gated_pixelcnn.py:143-149), for any n_samples
    labels = (np.arange(args.n_samples) % 10).astype(np.int32)
    generator = torch.Generator(device=prior.embedding.device).manual_seed(args.seed)
    images, codes = sample_images(vq_model, prior, labels, generator)
    out = args.out or "samples/samples.npz"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez(out, images=images, codes=codes, labels=labels)
    print(f"Saved {images.shape[0]} samples to {out}")
    if args.png:
        from vqvae_tpu_torch.pipelines.viz import save_image_grid

        # with 10 columns, class c fills column c
        n_cols = 10 if args.n_samples % 10 == 0 else 8
        print(f"Wrote {save_image_grid(images, args.png, n_cols=n_cols)}")
    return 0


def cmd_serve(args) -> int:
    """Continuous-batching sampling service behind an HTTP JSON API."""
    from vqvae_tpu_torch.pipelines.sample import decode_code_grids
    from vqvae_tpu_torch.pipelines.serve import SamplingHTTPServer, SamplingService
    from vqvae_tpu_torch.pipelines.viz import load_model, load_prior

    prior, _m, _hp = load_prior(args.prior_checkpoint, device=args.device,
                                fallback_cfg=_prior_flags_cfg(args))
    service = SamplingService(prior.config, prior, batch_size=args.serve_batch, seed=args.seed,
                              device=args.device)
    decode_fn = None
    if args.vqvae_checkpoint:
        vq_model, _m, _hp = load_model(
            args.vqvae_checkpoint, device=args.device,
            fallback_cfg=_vqvae_flags_cfg(args),
            quantizer_impl=args.quantizer_impl)
        decode_fn = lambda codes: decode_code_grids(vq_model, codes)  # noqa: E731

    service.start()
    server = SamplingHTTPServer(service, decode_fn, host=args.host, port=args.port)
    print(f"serving on http://{server.address[0]}:{server.address[1]} "
          f"(POST /sample, GET /healthz)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        service.stop()
    return 0


def cmd_profile(args) -> int:
    """A ``torch.profiler`` trace of training steps: one warm-up step outside
    the trace, then ``profile_steps`` steps each under ``train_step_<i>``,
    with a host read of the last loss inside the window. Each step's range
    holds the update's spans (``utils/profiling.py``)."""
    from vqvae_tpu_torch.config import TrainConfig
    from vqvae_tpu_torch.data.datasets import load_dataset
    from vqvae_tpu_torch.data.sampler import ReplacementSampler
    from vqvae_tpu_torch.device import resolve_device
    from vqvae_tpu_torch.train.vqvae_train import VQVAETrainer
    from vqvae_tpu_torch.utils.profiling import annotate, profile_trace

    resolve_device(args.device)  # refuse a missing card before reading the data
    train_ds, _val, x_train_var, _info = load_dataset(args.dataset, args.data_dir)
    trainer = VQVAETrainer(_vqvae_cfg_from_flags(args),
                           TrainConfig(batch_size=args.batch_size, seed=args.seed),
                           x_train_var=x_train_var, device=args.device)
    state = trainer.init_state()
    sampler = ReplacementSampler(len(train_ds), args.batch_size, seed=args.seed)
    # the first cuDNN calls and the kernels' load happen outside the trace
    state, m = trainer.step(state, train_ds.data[sampler.next_indices()])
    float(m["loss"])
    with profile_trace(args.trace_dir):
        for i in range(args.profile_steps):
            with annotate(f"train_step_{i}"):
                state, m = trainer.step(state, train_ds.data[sampler.next_indices()])
        float(m["loss"])  # a host read inside the window: the steps have run
    print(f"Wrote a torch.profiler trace of {args.profile_steps} steps to {args.trace_dir}")
    return 0


def cmd_viz(args) -> int:
    """Metric curves and reconstructions from a checkpoint (the notebook's
    evaluation, visualization.ipynb cells 1-8)."""
    from vqvae_tpu_torch.data.datasets import load_dataset
    from vqvae_tpu_torch.pipelines.viz import load_model, plot_metrics, reconstruct, save_image_grid

    model, metrics, hp = load_model(args.checkpoint, device=args.device,
                                    fallback_cfg=_vqvae_flags_cfg(args),
                                    quantizer_impl=args.quantizer_impl)
    out_dir = args.out_dir
    if metrics:
        print(f"Wrote {plot_metrics(metrics, f'{out_dir}/metrics.png')}")
    _train, val, _var, _info = load_dataset(hp.get("dataset", "CIFAR10"), args.data_dir)
    batch = val.data[: args.n_images]
    recons = reconstruct(model, batch)
    print(f"Wrote {save_image_grid(batch, f'{out_dir}/originals.png')}")
    print(f"Wrote {save_image_grid(recons, f'{out_dir}/reconstructions.png')}")
    return 0


def cmd_benchmark(args) -> int:
    """One JSON line: encode + quantize images/s at batch 1,024 in bench.py's two
    points and the train step at batch 256, measured (``vqvae_tpu_torch/bench``)."""
    import json

    from vqvae_tpu_torch.bench import run

    print(json.dumps(run(_vqvae_cfg_from_flags(args), args.device, args.iters_lo, args.iters_hi,
                         args.repeats)))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vqvae_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    tv = sub.add_parser("train-vqvae", help="train the VQ-VAE")
    _add_vqvae_flags(tv)
    _add_mesh_flags(tv)
    tv.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    tv.set_defaults(fn=cmd_train_vqvae)

    ex = sub.add_parser("extract-latents", help="dataset -> code indices .npy")
    _add_vqvae_flags(ex)
    ex.add_argument("--checkpoint", type=str, required=True)
    ex.add_argument("--out", type=str, default=None)
    ex.add_argument("--extract_batch", type=int, default=256)
    ex.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    ex.set_defaults(fn=cmd_extract_latents)

    tp = sub.add_parser("train-prior", help="train the GatedPixelCNN prior on latents")
    tp.add_argument("--batch_size", type=int, default=32)
    tp.add_argument("--epochs", type=int, default=100)
    tp.add_argument("--log_interval", type=int, default=100)
    tp.add_argument("-save", action="store_true",
                    help="save after every epoch, not only after the best validation loss")
    tp.add_argument("--img_dim", type=int, default=8)
    tp.add_argument("--n_embeddings", type=int, default=512)
    tp.add_argument("--n_layers", type=int, default=15)
    tp.add_argument("--learning_rate", type=float, default=3e-4)
    tp.add_argument("--seed", type=int, default=0)
    tp.add_argument("--data_dir", type=str, default="data")
    tp.add_argument("--results_dir", type=str, default="results")
    tp.add_argument("--gen_samples", action="store_true",
                    help="draw 10 samples of each class after every epoch "
                         "(reference gated_pixelcnn.py:143-149)")
    tp.add_argument("--compute_dtype", type=str, default="float32",
                    choices=["float32", "bfloat16"],
                    help="the prior's conv-stack dtype; params stay fp32, logits come out fp32")
    tp.add_argument("--conv_precision", type=str, default="highest",
                    choices=["highest", "high", "default"],
                    help="fp32 conv arithmetic: highest = no TF32")
    tp.add_argument("--resume", action="store_true",
                    help="resume from the saved prior checkpoint")
    tp.add_argument("--steps_per_dispatch", type=int, default=1,
                    help="updates per chunk, gathered on the device from the staged grids; "
                         "the losses are read back once a chunk")
    tp.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    _add_mesh_flags(tp, code_axis=False)
    tp.set_defaults(fn=cmd_train_prior)

    sm = sub.add_parser("sample", help="AR sample codes -> decode images")
    _add_vqvae_flags(sm)
    _add_prior_flags(sm)
    sm.add_argument("--vqvae-checkpoint", type=str, required=True)
    sm.add_argument("--prior-checkpoint", type=str, required=True)
    sm.add_argument("--n_samples", type=int, default=100)
    sm.add_argument("--out", type=str, default=None)
    sm.add_argument("--png", type=str, default=None,
                    help="also render the samples as one PNG grid (needs matplotlib)")
    sm.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    sm.set_defaults(fn=cmd_sample)

    sv = sub.add_parser("serve", help="HTTP sampling service (continuous batching)")
    _add_vqvae_flags(sv)
    _add_prior_flags(sv)
    sv.add_argument("--prior-checkpoint", type=str, required=True)
    sv.add_argument("--vqvae-checkpoint", type=str, default=None,
                    help="attach a decoder so /sample can return images")
    sv.add_argument("--host", type=str, default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8787)
    sv.add_argument("--serve_batch", type=int, default=64,
                    help="device slots per lockstep wave")
    sv.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    sv.set_defaults(fn=cmd_serve)

    pf = sub.add_parser("profile", help="a torch.profiler trace of train steps, each a range train_step_<i> "
                        "holding the update's spans: train.batch, train.forward (search.<route>[NxKxD] "
                        "in it), train.backward, search.backward, Optimizer.step#<class>.step, and on "
                        "several ranks parallel.mean and parallel.psum")
    _add_vqvae_flags(pf)
    pf.add_argument("--trace_dir", type=str, default="results/trace")
    pf.add_argument("--profile_steps", type=int, default=10)
    pf.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    pf.set_defaults(fn=cmd_profile)

    vz = sub.add_parser("viz", help="metric curves + reconstructions from a checkpoint")
    _add_vqvae_flags(vz)
    vz.add_argument("--checkpoint", type=str, required=True)
    vz.add_argument("--out_dir", type=str, default="results/viz")
    vz.add_argument("--n_images", type=int, default=16)
    vz.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    vz.set_defaults(fn=cmd_viz)

    from vqvae_tpu_torch.bench import add_window_flags

    bm = sub.add_parser("benchmark", help="the port's benchmark line (vqvae_tpu_torch/bench)")
    _add_vqvae_flags(bm)
    add_window_flags(bm)
    bm.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    bm.set_defaults(fn=cmd_benchmark)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
