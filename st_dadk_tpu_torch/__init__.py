"""PyTorch/CUDA port of st_dadk_tpu (spatio-temporal DeepKriging, DA-STDK).

Self-contained: imports torch, numpy, scipy and the standard library only —
never jax, yaml (except inside the YAML reader), pandas or st_dadk_tpu.
The fused basis first layer runs through hand-written CUDA kernels for
Hopper (`ops/fused_first_layer.py`, `csrc/`), built with nvcc at first use.
"""
__version__ = "0.1.0"
