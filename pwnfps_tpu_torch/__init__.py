"""PyTorch/CUDA port of pwnfps-tpu.

Mirrors the layout of `pwnfps_tpu` module for module.  Plain tensor
code is PyTorch; each Pallas kernel of the JAX package becomes a CUDA
C++ kernel for Hopper under `csrc/`, built at first use by `_build`.
The package imports neither jax nor anything of `pwnfps_tpu`: the host
modules it needs (level loader, object pool, world packing, camera,
config) are copies under the same names, each naming its original.
"""
