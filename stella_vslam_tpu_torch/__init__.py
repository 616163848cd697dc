"""stella_vslam_tpu_torch — the PyTorch/CUDA port of stella_vslam_tpu.

The JAX package `stella_vslam_tpu` stays the reference; this package mirrors
its layout and names so each module's counterpart is easy to find. Plain
tensor code is PyTorch; every device program on the ported path that the JAX
package shaped by hand for the TPU is a CUDA kernel written for Hopper
(`csrc/*.cu`, built with nvcc for sm_90a at first use, loaded with ctypes —
see `kernels/build.py`). Each kernel has a plain PyTorch version in the same
module: a wrapper takes that version only for tensors on the CPU, and for
CUDA tensors launches the kernel or raises.

This package imports torch and numpy, never jax or cv2.
"""

__version__ = "0.1.0"

import torch as _torch

# Precision policy of stella_vslam_tpu/__init__.py: geometry and optimization
# need true f32 matrix products. TF32 keeps ~3 decimal digits, which turns
# pixel noise into centimetres of map error, so it is off for matmuls and for
# cuDNN, and f32 matmul precision is "highest".
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
