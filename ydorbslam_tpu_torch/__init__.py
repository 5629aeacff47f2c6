"""ydorbslam_tpu_torch — the PyTorch/CUDA port of ``ydorbslam_tpu``.

The JAX package beside this one is the reference; this package mirrors
its module layout and names so each module's counterpart is easy to
find.  It imports ``torch`` and never ``jax`` or ``ydorbslam_tpu``.

What is ported so far is the RGB-D tracking slice with mapping off
(``slam.system.SlamSystem(..., enable_mapping=False)``): ORB extraction,
RGB-D depth association, motion-model projection matching, pose-only LM
and the appearance fallback.  The two TPU kernels on that path have
hand-written CUDA counterparts for Hopper (``csrc/``); every kernel has
a plain PyTorch version of the same contract that CPU tensors take.

State is created on an explicit ``device``; nothing here picks one.
"""

__version__ = "0.1.0"

import torch as _torch

# The JAX reference runs every float32 matmul at "highest" precision
# (ydorbslam_tpu/__init__.py); TF32 would keep ~3 decimal digits in
# the pose normal equations and the pyramid, so it stays off for both
# matmuls and cuDNN.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
