from .pyramid import (  # noqa: F401
    build_pyramid,
    gaussian_blur,
    pyramid_shapes,
    scale_factors,
    level_sigma2,
)
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
from .extractor import FrameFeatures, empty_features, extract_orb  # noqa: F401
from .stereo import fill_depth_from_rgbd, stereo_match  # noqa: F401
from .hamming import (  # noqa: F401
    INVALID_DIST,
    hamming_distance,
    distance_matrix,
    masked_distance_matrix,
    best_and_second,
    ratio_test_matches,
    filter_matches_by_rotation,
    proj_best2,
    proj_best2_plain,
    rotation_histogram_mask,
)
from .kernels import launch_counts, reset_launch_counts  # noqa: F401
