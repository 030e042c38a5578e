"""PyTorch + CUDA port of semantic_gaussians_tpu.

The JAX package beside this one is the reference. Each module here has one
counterpart there; the kernels the JAX package wrote in Pallas for the TPU
are hand-written CUDA C++ under `csrc/`, built at first use (ops.kernels).
Entry points run on the GPU unless the caller asks for the CPU.
"""
