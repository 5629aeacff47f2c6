from .trajectory import (  # noqa: F401
    write_tum_trajectory,
    read_tum_trajectory,
    associate_by_time,
    ate_rmse,
)
