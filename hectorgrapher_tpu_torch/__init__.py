"""PyTorch + CUDA port of hectorgrapher_tpu.

The 2D local SLAM front end (LocalTrajectoryBuilder2D) and the batched
real-time correlative + Gauss-Newton scan matcher, with the correlative
matcher's two kernels written by hand in CUDA for Hopper (ops/, csrc/).

Module layout mirrors hectorgrapher_tpu/: every module here is the
counterpart of the module with the same path there. The package imports
torch and numpy only; it never imports jax or hectorgrapher_tpu. Every
constructor and entry point takes an explicit torch device.
"""
