"""Pipelines: latent extraction and checkpoint reconstruction."""
