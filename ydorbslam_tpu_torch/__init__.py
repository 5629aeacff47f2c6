"""ydorbslam_tpu_torch — the PyTorch/CUDA port of ``ydorbslam_tpu``.

The JAX package beside this one is the reference; this package mirrors
its module layout and names so each module's counterpart is easy to
find.  It imports ``torch`` and never ``jax`` or ``ydorbslam_tpu``.

What is ported so far is the synchronous RGB-D and stereo paths with
local mapping on or off and loop closing (``slam.system.SlamSystem``):
ORB extraction, RGB-D depth association and stereo matching, projection
matching, pose-only LM, local-map tracking, keyframe insertion and local
mapping with its bundle adjustment, relocalization after tracking is
lost (retrieval index, RANSAC, pose LM), the localization-only mode,
loop closing with global BA, and the KITTI stereo runner
(``python -m ydorbslam_tpu_torch.apps.run_kitti_stereo``).  The four TPU kernels on that path have hand-written
CUDA counterparts for Hopper (``csrc/``); every kernel has a plain
PyTorch version of the same contract that CPU tensors take.

``SlamSystem`` and ``Tracker`` put their state on the card
(``device="cuda"``) unless the caller passes another device, as the CPU
tests pass ``device="cpu"``; without a card a CUDA request raises.
"""

__version__ = "0.1.0"

import torch as _torch

# The JAX reference runs every float32 matmul at "highest" precision
# (ydorbslam_tpu/__init__.py); TF32 would keep ~3 decimal digits in
# the pose normal equations and the pyramid, so it stays off for both
# matmuls and cuDNN.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
