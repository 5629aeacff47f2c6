from .trajectory import (  # noqa: F401
    write_tum_trajectory,
    read_tum_trajectory,
    associate_by_time,
    ate_rmse,
)
from .tum import TumRgbdDataset, load_image_gray  # noqa: F401
from .kitti import KittiStereoDataset, kitti_intrinsics  # noqa: F401
