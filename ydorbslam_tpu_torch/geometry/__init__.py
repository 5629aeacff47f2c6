from .se3 import (  # noqa: F401
    hat,
    vee,
    so3_exp,
    so3_log,
    se3_exp,
    se3_log,
    make_T,
    inv_T,
    orthonormalize_T,
    transform_points,
    rot_to_quat,
    quat_to_rot,
)
from .sim3 import (  # noqa: F401
    make_S,
    split_S,
    inv_S,
    sim3_exp,
    sim3_log,
    sim3_to_se3,
    se3_to_sim3,
    transform_points_S,
)
from .camera import (  # noqa: F401
    CameraIntrinsics,
    distort_normalized,
    undistort_points,
    project,
    project_stereo,
    backproject,
    in_image,
)
