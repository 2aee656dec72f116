"""Training: optimizer, metrics, checkpoints and the VQ-VAE trainer."""
