"""Training-side utilities; this slice has only the checkpoint reader."""
