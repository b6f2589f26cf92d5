"""Basis functions, the fused first-layer kernels, losses and center init."""
