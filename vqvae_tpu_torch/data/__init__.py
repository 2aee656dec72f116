"""Datasets and the batch sampler (numpy only)."""
