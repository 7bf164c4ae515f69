"""vistracker_tpu_torch: the PyTorch + CUDA port of vistracker_tpu.

Same subpackage layout as the JAX package (core, ops, models, fit, data,
utils, cli); hand-written Hopper kernels live under csrc/ and are built
with nvcc at first use (utils/cuda_build.py). The package imports torch,
numpy and scipy only -- never jax, flax, optax or vistracker_tpu.

Entry point: ``python -m vistracker_tpu_torch.cli.main track --neural-only``.
"""
