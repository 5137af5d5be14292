"""ATE / RPE trajectory evaluation (TUM benchmark semantics).

A copy of orb_slam2_test_tpu/evaluation/ate.py (numpy only; the port
imports nothing of the JAX package). It reimplements what the reference delegates to the external TUM tools:
  - associate.py      -> associate_trajectories (nearest-timestamp match)
  - evaluate_ate.py   -> umeyama_alignment + absolute_trajectory_error
  - evaluate_rpe.py   -> relative_pose_error
Monocular evaluation uses with_scale=True (Sim3 alignment — mono SLAM
has a free global scale); stereo/RGB-D uses SE3 (with_scale=False).
"""

from __future__ import annotations

import numpy as np


def _associate(est: list, gt: list, max_dt: float) -> list:
    """Greedy nearest-timestamp association: [(index in est, index in
    gt)], in est's order."""
    gt_t = np.array([t for t, _ in gt])
    pairs = []
    used = set()
    for k, (t, _) in enumerate(est):
        i = int(np.argmin(np.abs(gt_t - t)))
        if abs(gt_t[i] - t) <= max_dt and i not in used:
            used.add(i)
            pairs.append((k, i))
    return pairs


def associate_trajectories(
    est: list, gt: list, max_dt: float = 0.02
) -> list:
    """Greedy nearest-timestamp association of two [(t, T4x4)] lists.
    Returns [(T_est, T_gt)] pairs."""
    return [(est[k][1], gt[i][1]) for k, i in _associate(est, gt, max_dt)]


def _centers(Ts: np.ndarray, camera_to_world: bool) -> np.ndarray:
    """[n,4,4] poses -> [n,3] camera centers."""
    if camera_to_world:
        return Ts[:, :3, 3]
    R = Ts[:, :3, :3]
    t = Ts[:, :3, 3]
    return -np.einsum("nij,nj->ni", R.transpose(0, 2, 1), t)


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = False
):
    """Least-squares similarity transform aligning src -> dst.

    src, dst: [n, 3]. Returns (s, R, t) with dst ~ s * R @ src + t.
    Classic Umeyama (1991); with_scale=False gives the SE3 (Horn) case.
    """
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    H = xd.T @ xs / len(src)
    U, S, Vt = np.linalg.svd(H)
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1.0
    R = U @ D @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(S) @ D) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def aligned_errors(
    est: list,
    gt: list,
    with_scale: bool = False,
    max_dt: float = 0.02,
    est_camera_to_world: bool = False,
    gt_camera_to_world: bool = True,
) -> tuple[np.ndarray, np.ndarray, float]:
    """absolute_trajectory_error's alignment, pose by pose: the
    timestamps of est's associated poses, each one's camera-centre error
    after the alignment (m), and the alignment's scale. Fewer than two
    pairs align nothing: their errors and the scale are nan."""
    pairs = _associate(est, gt, max_dt)
    times = np.array([est[k][0] for k, _ in pairs])
    if len(pairs) < 2:
        return times, np.full(len(pairs), np.nan), float("nan")
    Te = np.stack([est[k][1] for k, _ in pairs])
    Tg = np.stack([gt[i][1] for _, i in pairs])
    ce = _centers(Te, est_camera_to_world)
    cg = _centers(Tg, gt_camera_to_world)
    s, R, t = umeyama_alignment(ce, cg, with_scale)
    aligned = s * ce @ R.T + t
    return times, np.linalg.norm(aligned - cg, axis=1), s


def absolute_trajectory_error(
    est: list,
    gt: list,
    with_scale: bool = False,
    max_dt: float = 0.02,
    est_camera_to_world: bool = False,
    gt_camera_to_world: bool = True,
) -> dict:
    """ATE RMSE between an estimated trajectory [(t, Tcw)] and ground
    truth [(t, Twc)] (TUM GT files are camera-to-world).

    Returns {'rmse', 'mean', 'median', 'max', 'n_pairs', 'scale'}.
    """
    _, err, s = aligned_errors(est, gt, with_scale, max_dt, est_camera_to_world,
                               gt_camera_to_world)
    if len(err) < 2:
        return {"rmse": float("inf"), "n_pairs": len(err)}
    return {
        "rmse": float(np.sqrt((err ** 2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "max": float(err.max()),
        "n_pairs": len(err),
        "scale": s,
    }


def relative_pose_error(
    est: list,
    gt: list,
    delta: int = 1,
    max_dt: float = 0.02,
    est_camera_to_world: bool = False,
    gt_camera_to_world: bool = True,
) -> dict:
    """RPE over a fixed frame delta: translational drift RMSE (m) and
    rotational drift RMSE (deg) of relative motions."""
    pairs = associate_trajectories(est, gt, max_dt)
    if len(pairs) < delta + 1:
        return {"trans_rmse": float("inf"), "n_pairs": len(pairs)}

    def to_w(T, c2w):
        return T if c2w else np.linalg.inv(T)

    Te = [to_w(p[0], est_camera_to_world) for p in pairs]
    Tg = [to_w(p[1], gt_camera_to_world) for p in pairs]
    terr, rerr = [], []
    for i in range(len(pairs) - delta):
        de = np.linalg.inv(Te[i]) @ Te[i + delta]
        dg = np.linalg.inv(Tg[i]) @ Tg[i + delta]
        e = np.linalg.inv(dg) @ de
        terr.append(np.linalg.norm(e[:3, 3]))
        c = (np.trace(e[:3, :3]) - 1) / 2
        rerr.append(np.degrees(np.arccos(np.clip(c, -1, 1))))
    terr = np.array(terr)
    rerr = np.array(rerr)
    return {
        "trans_rmse": float(np.sqrt((terr ** 2).mean())),
        "rot_rmse_deg": float(np.sqrt((rerr ** 2).mean())),
        "n_pairs": len(pairs),
    }
