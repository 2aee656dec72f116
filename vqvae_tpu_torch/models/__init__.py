"""Models: the VQ-VAE and its encoder, decoder and residual blocks."""
