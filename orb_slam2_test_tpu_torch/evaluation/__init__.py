"""Trajectory evaluation: ATE / RPE (a copy of the JAX package's
`evaluation`, numpy only)."""

from orb_slam2_test_tpu_torch.evaluation.ate import (  # noqa: F401
    absolute_trajectory_error,
    aligned_errors,
    associate_trajectories,
    relative_pose_error,
    umeyama_alignment,
)
