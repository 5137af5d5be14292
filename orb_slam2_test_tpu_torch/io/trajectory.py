"""Trajectory export/import: TUM and KITTI formats.

A copy of orb_slam2_test_tpu/io/trajectory.py (numpy only; the port
imports nothing of the JAX package). It replaces System::SaveTrajectoryTUM (src/System.cc:~340),
SaveTrajectoryKITTI (:~430) and SaveKeyFrameTrajectoryTUM. TUM rows are
'timestamp tx ty tz qx qy qz qw' (camera-to-world); KITTI rows are the
flattened 3x4 [R|t] of Twc, one per frame, no timestamps.
"""

from __future__ import annotations

import numpy as np


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w), TUM ordering
    (reference Converter::toQuaternion via Eigen)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    """Quaternion (x, y, z, w) -> rotation matrix."""
    x, y, z, w = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def save_trajectory_tum(path: str, traj: list) -> None:
    """traj: list of (timestamp, Tcw 4x4). Writes camera-to-world rows."""
    with open(path, "w") as f:
        for ts, Tcw in traj:
            Tcw = np.asarray(Tcw)
            Rwc = Tcw[:3, :3].T
            twc = -Rwc @ Tcw[:3, 3]
            q = _rot_to_quat(Rwc)
            f.write(
                f"{ts:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def save_trajectory_kitti(path: str, traj: list) -> None:
    """traj: list of (timestamp, Tcw 4x4). Writes flattened Twc 3x4."""
    with open(path, "w") as f:
        for _, Tcw in traj:
            Tcw = np.asarray(Tcw)
            Rwc = Tcw[:3, :3].T
            twc = -Rwc @ Tcw[:3, 3]
            M = np.concatenate([Rwc, twc[:, None]], axis=1)
            f.write(" ".join(f"{v:.9e}" for v in M.reshape(-1)) + "\n")


def load_trajectory_tum(path: str) -> list:
    """Read a TUM-format trajectory (ours or ground truth) into a list
    of (timestamp, Twc 4x4)."""
    out = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.replace(",", " ").split()]
            t, tx, ty, tz, qx, qy, qz, qw = v[:8]
            T = np.eye(4)
            T[:3, :3] = quat_to_rot(np.array([qx, qy, qz, qw]))
            T[:3, 3] = (tx, ty, tz)
            out.append((t, T))
    return out


def load_trajectory_kitti(path: str) -> list:
    """Read a KITTI-format pose file into a list of (index, Twc 4x4)."""
    out = []
    with open(path, "r") as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            v = np.array([float(x) for x in line.split()]).reshape(3, 4)
            T = np.eye(4)
            T[:3, :] = v
            out.append((float(i), T))
    return out
