from .pyramid import build_pyramid, pyramid_shapes, scale_factors, level_sigma2  # noqa: F401
from .fast import (  # noqa: F401
    fast_score_map,
    fast_score_nms,
    fast_score_nms_levels,
    fast_subpixel_offsets,
    nms_and_border,
    two_threshold_mask,
)
from .select import select_topk_cells, level_budgets  # noqa: F401
from .descriptors import (  # noqa: F401
    brief_pattern,
    extract_patches,
    orientation_from_patches,
    brief_from_patches,
)
from .extractor import FrameFeatures, extract_orb  # noqa: F401
from .stereo import fill_depth_from_rgbd, stereo_match  # noqa: F401
from .hamming import (  # noqa: F401
    INVALID_DIST,
    distance_matrix,
    masked_distance_matrix,
    proj_best2,
    proj_best2_plain,
    rotation_histogram_mask,
)
from .kernels import launch_counts, reset_launch_counts  # noqa: F401
