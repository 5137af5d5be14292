"""Core geometry: SE3 / Sim3 Lie groups, the pinhole camera with its
distortion, triangulation and the robust-loss constants."""

from orb_slam2_test_tpu_torch.geometry.se3 import (
    se3_exp,
    se3_log,
    so3_exp,
    so3_log,
    se3_inverse,
    se3_compose,
    se3_apply,
    quat_from_rotmat,
    rotmat_from_quat,
)
from orb_slam2_test_tpu_torch.geometry.sim3 import (
    sim3_exp,
    sim3_log,
    sim3_inverse,
    sim3_compose,
    sim3_apply,
    sim3_from_se3,
    se3_from_sim3,
)
from orb_slam2_test_tpu_torch.geometry.camera import (
    PinholeCamera,
    project,
    project_stereo,
    backproject,
    undistort_points,
    distort_points,
)
from orb_slam2_test_tpu_torch.geometry.triangulation import (
    triangulate_dlt,
    triangulation_checks,
)
from orb_slam2_test_tpu_torch.geometry.robust import (
    huber_weight,
    CHI2_MONO,
    CHI2_STEREO,
)
