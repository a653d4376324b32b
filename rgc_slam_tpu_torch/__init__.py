"""PyTorch port of rgc_slam_tpu, for CUDA (Hopper) and the CPU.

The JAX package ``rgc_slam_tpu`` is the reference; this package mirrors its
layout and names module by module and never imports jax.

Precision policy (the counterpart of ``rgc_slam_tpu/__init__.py``): SLAM is
estimation, so every float32 matrix product runs in full float32.  TF32
keeps about three decimal digits, which corrupts squared distances at
map-scale coordinates and the Gauss-Newton normal equations; the JAX package
measured a 10x worse trajectory ATE without its pin.
"""
import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
