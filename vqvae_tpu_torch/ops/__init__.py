"""Ops: torch-semantics convolutions and the vector-quantization bottleneck."""
