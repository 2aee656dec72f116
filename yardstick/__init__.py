"""The benchmark of ``vqvae_tpu_torch`` on NVIDIA H100 cards (``python -m
yardstick``; see ``run.py``). Cells, configurations, traffic and per-layer
metrics are data files under this folder, found by name (``spec.py``)."""
