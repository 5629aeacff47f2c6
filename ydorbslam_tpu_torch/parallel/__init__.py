"""Multi-process runs over ``torch.distributed``: one rank per device.

Port of ``ydorbslam_tpu/parallel/``.  ``multihost`` joins the run
(``initialize_distributed``) and hands sharded code its ``ShardGroup``
(``device_mesh``); ``ba_sharded`` holds the point-sharded bundle
adjustment that the loop closer's global BA runs on more than one rank;
``retrieval_sharded`` the keyframe-sharded scoring of loop detection;
``launch`` spawns ranks on one host for the tests and ``chip_smoke.py``.
"""
from .multihost import (
    ShardGroup, device_mesh, distributed_env, initialize_distributed, is_writer, process_info,
)

__all__ = ["ShardGroup", "device_mesh", "distributed_env", "initialize_distributed",
           "is_writer", "process_info"]
