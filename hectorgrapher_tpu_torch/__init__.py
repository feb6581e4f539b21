"""PyTorch + CUDA port of hectorgrapher_tpu.

The 2D and 3D local SLAM front ends, the 2D and 3D back ends, serving,
distribution and the host modules (configuration, evaluation, metrics),
with the JAX package's two Pallas kernels and its hot XLA fusions written
by hand in CUDA for Hopper (ops/, csrc/).

Module layout mirrors hectorgrapher_tpu/: every module here is the
counterpart of the module with the same path there. The package imports
torch and numpy only; it never imports jax or hectorgrapher_tpu. Every
constructor and entry point takes an explicit torch device.
"""
