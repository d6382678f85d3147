"""PyTorch/CUDA port of pwnfps-tpu.

Mirrors the layout of `pwnfps_tpu` module for module.  Plain tensor
code is PyTorch; each Pallas kernel of the JAX package becomes a CUDA
C++ kernel for Hopper under `csrc/`, built at first use by `_build`.
The jax-free host modules of `pwnfps_tpu` (level loader, object pool,
world packing, camera, config) are imported, not copied.  This package
never imports jax.
"""
