"""Data and codebook parallelism on ``torch.distributed`` (port of ``vqvae_tpu/parallel``)."""
