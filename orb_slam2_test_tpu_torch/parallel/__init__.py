"""Distributed bundle adjustment, joint multi-sequence mapping and the
process group's bring-up (port of orb_slam2_test_tpu/parallel/)."""

from orb_slam2_test_tpu_torch.parallel.dist_ba import (
    dist_bundle_adjust,
    make_ba_mesh,
    shard_problem,
)
from orb_slam2_test_tpu_torch.parallel.multi_map import (
    compact_problem,
    joint_bundle_adjust,
    measure_scaling,
    merge_problems,
)
from orb_slam2_test_tpu_torch.parallel.multihost import (
    global_ba_mesh,
    initialize_from_env,
    make_global_problem,
)

__all__ = [
    "dist_bundle_adjust",
    "make_ba_mesh",
    "shard_problem",
    "compact_problem",
    "joint_bundle_adjust",
    "measure_scaling",
    "merge_problems",
    "global_ba_mesh",
    "initialize_from_env",
    "make_global_problem",
]
