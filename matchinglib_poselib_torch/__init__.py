"""matchinglib_poselib_torch — PyTorch/CUDA port of matchinglib_poselib_tpu.

The JAX package beside it is the reference this port is held against. The
port keeps its module and function names and its fixed-shape, masked slot
layout, runs plain PyTorch on CPU tensors, and on CUDA tensors replaces the
Pallas TPU kernels (FAST+NMS, the binary and the float 2-NN bodies) with
CUDA C++ kernels written for sm_90a (``ops/kernels``; sources under
``csrc/``).

The port imports torch and never jax.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry and solver math needs true f32 products (the JAX package sets
# jax_default_matmul_precision="highest" for the same reason): TF32 keeps
# ~3 decimal digits, which breaks essential-matrix projections and
# rotation orthonormality.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from matchinglib_poselib_torch.config import (  # noqa: E402,F401
    MatchingConfig,
    PoseConfig,
    RobustConfig,
    StereoRefineConfig,
)
