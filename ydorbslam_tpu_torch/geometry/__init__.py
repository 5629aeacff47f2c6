from .se3 import (  # noqa: F401
    hat,
    so3_exp,
    se3_exp,
    make_T,
    inv_T,
    orthonormalize_T,
)
from .camera import (  # noqa: F401
    CameraIntrinsics,
    distort_normalized,
    undistort_points,
    backproject,
)
