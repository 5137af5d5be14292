"""Synthetic scenes and image sequences with exact ground truth.

A copy of the parts of orb_slam2_test_tpu/utils/synthetic.py that the
sequences need (`default_camera`, `make_landmarks`, `_landmark_patches`,
`render_frame`, `make_sequence`, the closed-loop scene
`make_loop_trajectory` / `make_loop_scene` / `render_loop_sequence`,
and `synthetic_ba_problem`), with the port's camera and `se3_exp`:
random 3D landmarks rendered as textured planar quads, seen from known
camera trajectories. Rendering is NumPy on the host;
`render_loop_stereo` renders a long stereo loop in a process pool into
memory (the frames that tools/make_synth_data.py's `kitti` writes as PNG
files, as examples/make_synth_data.py does).
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.geometry.se3 import se3_exp


def default_camera(width: int = 320, height: int = 240) -> PinholeCamera:
    return PinholeCamera(
        fx=0.8 * width,
        fy=0.8 * width,
        cx=width / 2.0,
        cy=height / 2.0,
        width=width,
        height=height,
    )


def make_landmarks(
    rng: np.random.Generator,
    n: int = 400,
    depth_range: tuple[float, float] = (4.0, 10.0),
    spread: float = 6.0,
) -> np.ndarray:
    """Random 3D landmarks in front of the origin (z in depth_range)."""
    xy = rng.uniform(-spread, spread, size=(n, 2))
    z = rng.uniform(*depth_range, size=(n, 1))
    return np.concatenate([xy, z], axis=1).astype(np.float32)


_PATCH_R = 15  # textured patch half-size; must cover BRIEF's 13-px
# pattern radius so descriptor bits compare texture, not background


def _landmark_patches(n: int, seed: int = 7) -> np.ndarray:
    """[n, 2R+1, 2R+1] deterministic random textured patches.

    Each landmark renders as a distinctive smoothed random texture so
    that BRIEF descriptors are discriminative and orientation is stable
    (pure Gaussian blobs are radially symmetric — unmatchable)."""
    rng = np.random.default_rng(seed)
    size = 2 * _PATCH_R + 1
    pat = rng.uniform(0.0, 255.0, size=(n, size, size)).astype(np.float32)
    # Texture model tuned for ORB stability under viewpoint change
    # (measured on true-correspondence pairs; per-texel white noise
    # flips ~100/256 BRIEF bits across a 2-degree view change and
    # IC_Angle jitters by ~15-30 degrees, killing long-sequence
    # tracking):
    # 1) heavy smoothing (8x 3x3 box ~ Gaussian sigma 2.3 texels) for
    #    sub-pixel stability,
    # 2) median-threshold to TWO TONES — BRIEF then compares large
    #    uniform regions whose comparisons survive moderate affine
    #    warps, like the edge/corner structure of real images,
    # 3) an additive dominant-direction ramp to pin the intensity
    #    centroid (stable IC_Angle -> stable steered BRIEF).
    for _ in range(8):
        p = np.pad(pat, ((0, 0), (1, 1), (1, 1)), mode="edge")
        pat = (
            p[:, :-2, :-2] + p[:, :-2, 1:-1] + p[:, :-2, 2:]
            + p[:, 1:-1, :-2] + p[:, 1:-1, 1:-1] + p[:, 1:-1, 2:]
            + p[:, 2:, :-2] + p[:, 2:, 1:-1] + p[:, 2:, 2:]
        ) / 9.0
    med = np.median(pat, axis=(1, 2), keepdims=True)
    pat = np.where(pat > med, 255.0, 40.0).astype(np.float32)
    yy, xx = np.mgrid[-_PATCH_R : _PATCH_R + 1, -_PATCH_R : _PATCH_R + 1]
    phi = rng.uniform(0.0, 2.0 * np.pi, size=n)
    ramp = 0.5 + 0.5 * (
        np.cos(phi)[:, None, None] * xx + np.sin(phi)[:, None, None] * yy
    ) / _PATCH_R
    pat = pat * 0.75 + 255.0 * 0.25 * ramp
    # one antialias pass over the hard two-tone edges
    p = np.pad(pat, ((0, 0), (1, 1), (1, 1)), mode="edge")
    pat = (
        p[:, :-2, :-2] + p[:, :-2, 1:-1] + p[:, :-2, 2:]
        + p[:, 1:-1, :-2] + p[:, 1:-1, 1:-1] + p[:, 1:-1, 2:]
        + p[:, 2:, :-2] + p[:, 2:, 1:-1] + p[:, 2:, 2:]
    ) / 9.0
    # radial window so the patch fades into the background
    wnd = np.clip(1.3 - np.sqrt(yy**2 + xx**2) / _PATCH_R, 0.0, 1.0)
    return (pat * wnd[None]).astype(np.float32)


def render_frame(
    cam: PinholeCamera,
    Tcw: np.ndarray,
    landmarks: np.ndarray,
    intensities: np.ndarray,
    background: float = 16.0,
    patches: np.ndarray | None = None,
    normals: np.ndarray | None = None,
    ref_dist: np.ndarray | None = None,
    return_depth: bool = False,
):
    """Render landmarks as textured PLANAR QUADS in 3D -> [H, W] image.

    Each landmark is a small textured plane with a fixed world size,
    projected with the true (affine-approximated) homography per frame,
    so every texture corner moves exactly like a rigid 3D point —
    billboard sprites would violate rigidity and corrupt SLAM geometry
    on rotating trajectories. Pure NumPy (a host-side utility).

    normals: [n, 3] quad normals (default: -z, facing a camera near the
    origin); ref_dist: [n] nominal viewing distance fixing the quad's
    world size (default |X|).
    """
    h, w = cam.height, cam.width
    R, t = Tcw[:3, :3], Tcw[:3, 3]
    n_lm = len(landmarks)
    if patches is None:
        patches = _landmark_patches(n_lm)
    if normals is None:
        normals = np.tile(
            np.array([0.0, 0.0, -1.0], np.float32), (n_lm, 1)
        )
    if ref_dist is None:
        ref_dist = np.linalg.norm(landmarks, axis=1)
    gain = intensities / 255.0
    size = 2 * _PATCH_R + 1

    pc = landmarks @ R.T + t
    z = pc[:, 2]
    vis = z > 0.5
    u0 = cam.fx * pc[:, 0] / np.maximum(z, 0.5) + cam.cx
    v0 = cam.fy * pc[:, 1] / np.maximum(z, 0.5) + cam.cy
    vis &= (u0 >= -25) & (u0 < w + 25) & (v0 >= -25) & (v0 < h + 25)

    # quad in-plane axes (world): e1 = up x n, e2 = n x e1
    up = np.array([0.0, 1.0, 0.0], np.float32)
    e1 = np.cross(np.tile(up, (n_lm, 1)), normals)
    n1 = np.linalg.norm(e1, axis=1, keepdims=True)
    e1 = e1 / np.maximum(n1, 1e-6)
    e2 = np.cross(normals, e1)
    texel = (ref_dist / cam.fx).astype(np.float32)  # 1 px at ref distance

    img = np.full((h, w), background, dtype=np.float32)
    zbuf = np.full((h, w), np.inf, np.float32)
    ys_g, xs_g = np.mgrid[0:h, 0:w].astype(np.float32)

    for li in np.nonzero(vis)[0]:
        # camera-frame axes steps per texel
        d1 = R @ e1[li] * texel[li]
        d2 = R @ e2[li] * texel[li]
        x, y, zz = pc[li]
        # image Jacobian d(uv)/d(texel): du = fx (d1x z - x d1z)/z^2 ...
        A = np.array(
            [
                [
                    cam.fx * (d1[0] * zz - x * d1[2]) / zz**2,
                    cam.fx * (d2[0] * zz - x * d2[2]) / zz**2,
                ],
                [
                    cam.fy * (d1[1] * zz - y * d1[2]) / zz**2,
                    cam.fy * (d2[1] * zz - y * d2[2]) / zz**2,
                ],
            ]
        )
        det = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
        if abs(det) < 1e-9:
            continue
        Ainv = np.array(
            [[A[1, 1], -A[0, 1]], [-A[1, 0], A[0, 0]]]
        ) / det
        # bounding box from transformed patch corners
        corners = A @ np.array(
            [[-_PATCH_R, _PATCH_R, -_PATCH_R, _PATCH_R],
             [-_PATCH_R, -_PATCH_R, _PATCH_R, _PATCH_R]],
            np.float32,
        )
        x0 = max(int(np.floor(u0[li] + corners[0].min())), 0)
        x1 = min(int(np.ceil(u0[li] + corners[0].max())) + 1, w)
        y0 = max(int(np.floor(v0[li] + corners[1].min())), 0)
        y1 = min(int(np.ceil(v0[li] + corners[1].max())) + 1, h)
        if x0 >= x1 or y0 >= y1:
            continue
        px = xs_g[y0:y1, x0:x1] - u0[li]
        py = ys_g[y0:y1, x0:x1] - v0[li]
        t1 = Ainv[0, 0] * px + Ainv[0, 1] * py  # texel coords
        t2 = Ainv[1, 0] * px + Ainv[1, 1] * py
        inside = (np.abs(t1) < _PATCH_R) & (np.abs(t2) < _PATCH_R)
        if not inside.any():
            continue
        # bilinear texture sample
        tx = np.clip(t1 + _PATCH_R, 0, size - 1.001)
        ty = np.clip(t2 + _PATCH_R, 0, size - 1.001)
        ix = tx.astype(np.int32)
        iy = ty.astype(np.int32)
        fx_ = tx - ix
        fy_ = ty - iy
        p = patches[li] * gain[li]
        val = (
            p[iy, ix] * (1 - fy_) * (1 - fx_)
            + p[iy, ix + 1] * (1 - fy_) * fx_
            + p[iy + 1, ix] * fy_ * (1 - fx_)
            + p[iy + 1, ix + 1] * fy_ * fx_
        )
        # exact per-pixel depth on the quad surface
        zq = zz + t1 * d1[2] + t2 * d2[2]
        sub_img = img[y0:y1, x0:x1]
        sub_z = zbuf[y0:y1, x0:x1]
        put = inside & (zq < sub_z)
        sub_img[put] = val[put]
        sub_z[put] = zq[put]
    img = np.clip(img, 0.0, 255.0)
    if return_depth:
        depth = np.where(np.isfinite(zbuf), zbuf, 0.0).astype(np.float32)
        return img, depth
    return img


def make_sequence(
    rng: np.random.Generator,
    n_frames: int,
    cam: PinholeCamera | None = None,
    n_landmarks: int = 400,
    step: np.ndarray | None = None,
):
    """A simple lateral-translation trajectory with small rotations.

    Returns (cam, poses [n, 4, 4] Tcw, landmarks [m, 3], images list).
    """
    cam = cam or default_camera()
    landmarks = make_landmarks(rng, n_landmarks)
    intensities = rng.uniform(140.0, 255.0, size=(n_landmarks,)).astype(
        np.float32
    )
    patches = _landmark_patches(n_landmarks)
    if step is None:
        step = np.array([0.15, 0.01, 0.0, 0.001, 0.004, 0.001])

    poses = []
    images = []
    for i in range(n_frames):
        xi = torch.tensor(step * i, dtype=torch.float32)
        Tcw = se3_exp(xi).numpy()
        poses.append(Tcw)
        images.append(
            render_frame(cam, Tcw, landmarks, intensities, patches=patches)
        )
    return cam, np.stack(poses), landmarks, images


# ---------------------------------------------------------------------------
# Closed-loop sequences (a copy of the JAX package's loop scene) and the
# KITTI-shaped bundle problem
# ---------------------------------------------------------------------------


def make_loop_trajectory(
    n_frames: int,
    radius: float = 50.0,
    revolutions: float = 1.08,
    y_wobble: float = 0.15,
) -> np.ndarray:
    """A circular drive in the x-z plane, the camera looking along the
    tangent (a closed loop: the end revisits the start). revolutions > 1
    adds frames past the revisit; y_wobble a slow vertical oscillation.
    Returns Tcw [n, 4, 4] float32."""
    thetas = np.linspace(0.0, 2.0 * np.pi * revolutions, n_frames, dtype=np.float64)
    poses = np.zeros((n_frames, 4, 4), np.float32)
    for i, th in enumerate(thetas):
        p = np.array([radius * np.cos(th), y_wobble * np.sin(3.0 * th), radius * np.sin(th)])
        z_cam = np.array([-np.sin(th), 0.0, np.cos(th)])  # the tangent
        y_cam = np.array([0.0, 1.0, 0.0])
        x_cam = np.cross(y_cam, z_cam)
        R_wc = np.stack([x_cam, y_cam, z_cam], axis=1)
        Tcw = np.eye(4)
        Tcw[:3, :3] = R_wc.T
        Tcw[:3, 3] = -R_wc.T @ p
        poses[i] = Tcw
    return poses


def make_loop_scene(
    rng: np.random.Generator,
    n_landmarks: int,
    radius: float = 50.0,
    wall_near: float = 3.0,
    wall_far: float = 12.0,
    y_spread: float = 4.0,
):
    """Landmarks lining a circular corridor: textured quads on the inner
    and outer walls, each facing the point of the path 0.35 rad or 20 m
    of arc behind it, whichever is shorter (where it is seen from), at
    log-uniform sizes so corners appear across the pyramid's octaves.
    Returns (landmarks [m, 3], intensities [m], patches, normals [m, 3],
    ref_dist [m])."""
    th = rng.uniform(0.0, 2.0 * np.pi, size=n_landmarks)
    side = np.where(rng.uniform(size=n_landmarks) < 0.5, 1.0, -1.0)
    off = rng.uniform(wall_near, wall_far, size=n_landmarks)
    r = radius + side * off
    y = rng.uniform(-y_spread, y_spread, size=n_landmarks)
    landmarks = np.stack([r * np.cos(th), y, r * np.sin(th)], axis=1).astype(np.float32)
    # The viewpoint lies 0.35 rad of arc back, or 20 m where that is
    # shorter. The JAX package's commit 4e42fb9 made it 20 m at every
    # radius to stop 0.35 rad (38 m) turning arcs edge-on at radius 110;
    # below 20 / 0.35 = 57.14 m that lengthens the offset instead (1.33 rad
    # at EuRoC's 15 m), which magnifies the quads in view 2.1-2.6x and
    # loses mono EuRoC from frame 53-58. The recorded EuRoC and TUM runs
    # predate it. At radius >= 57.15 m this is the JAX package's formula, bit for
    # bit; below, the one before 4e42fb9.
    th_view = th - min(0.35, 20.0 / max(radius, 1.0))
    viewpoint = np.stack(
        [radius * np.cos(th_view), np.zeros_like(th_view), radius * np.sin(th_view)], axis=1)
    normals = viewpoint - landmarks
    normals = (normals / np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-6)
               ).astype(np.float32)
    size_mult = np.exp(rng.uniform(np.log(1.0), np.log(5.0), size=n_landmarks))
    ref_dist = (np.linalg.norm(viewpoint - landmarks, axis=1) * size_mult).astype(np.float32)
    intensities = rng.uniform(120.0, 255.0, size=n_landmarks).astype(np.float32)
    patches = _landmark_patches(n_landmarks, seed=int(rng.integers(1 << 30)))
    return landmarks, intensities, patches, normals, ref_dist


def _right_pose(Tcw: np.ndarray, baseline: float) -> np.ndarray:
    """The right camera of a rectified pair: x-translated by -baseline."""
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -baseline
    return T_rl @ Tcw


def render_loop_sequence(
    rng: np.random.Generator,
    n_frames: int,
    cam: PinholeCamera,
    n_landmarks: int = 4000,
    radius: float = 50.0,
    baseline: float = 0.0,
    blackout: tuple = (),
    with_depth: bool = False,
    revolutions: float = 1.08,
):
    """A closed-loop sequence, rendered in this process. Returns a dict:
    poses [n, 4, 4] (Tcw, left camera), left (list of [H, W] float32),
    and right (baseline > 0) and depth (with_depth). Frames in
    `blackout` are flat background."""
    poses = make_loop_trajectory(n_frames, radius, revolutions)
    landmarks, intens, patches, normals, ref_dist = make_loop_scene(rng, n_landmarks, radius)
    kw = dict(patches=patches, normals=normals, ref_dist=ref_dist)
    left, right, depth = [], [], []
    blackset = set(int(b) for b in blackout)
    bg = 16.0
    for i in range(n_frames):
        Tcw = poses[i]
        if i in blackset:
            flat = np.full((cam.height, cam.width), bg, np.float32)
            left.append(flat)
            if baseline > 0.0:
                right.append(flat.copy())
            if with_depth:
                depth.append(np.zeros((cam.height, cam.width), np.float32))
            continue
        if with_depth:
            img, d = render_frame(cam, Tcw, landmarks, intens, return_depth=True, **kw)
            depth.append(d)
        else:
            img = render_frame(cam, Tcw, landmarks, intens, **kw)
        left.append(img)
        if baseline > 0.0:
            right.append(render_frame(cam, _right_pose(Tcw, baseline), landmarks, intens, **kw))
    out = {"poses": poses, "left": left}
    if baseline > 0.0:
        out["right"] = right
    if with_depth:
        out["depth"] = depth
    return out


def _render_loop_chunk(job) -> tuple[int, np.ndarray]:
    """Worker: render frames [lo, hi) of the seeded loop sequence as
    uint8 [hi - lo, 2, H, W] (the scene and trajectory rebuilt from the
    seed in each process)."""
    (lo, hi, n_frames, radius, revolutions, n_landmarks, seed, cam, baseline) = job
    poses = make_loop_trajectory(n_frames, radius, revolutions)
    landmarks, intens, patches, normals, ref_dist = make_loop_scene(
        np.random.default_rng(seed), n_landmarks, radius)
    kw = dict(patches=patches, normals=normals, ref_dist=ref_dist)
    out = np.empty((hi - lo, 2, cam.height, cam.width), np.uint8)
    for i in range(lo, hi):
        out[i - lo, 0] = np.clip(render_frame(cam, poses[i], landmarks, intens, **kw), 0, 255)
        out[i - lo, 1] = np.clip(render_frame(cam, _right_pose(poses[i], baseline), landmarks,
                                              intens, **kw), 0, 255)
    return lo, out


def loop_chunk_jobs(n_frames: int, cam: PinholeCamera, radius: float, revolutions: float,
                    n_landmarks: int, seed: int) -> list:
    """`_render_loop_chunk`'s jobs for the seeded stereo loop: chunks of
    at most 16 frames, the right camera at cam.bf / cam.fx."""
    bounds = list(range(0, n_frames, 16)) + [n_frames]
    return [(lo, hi, n_frames, radius, revolutions, n_landmarks, seed, cam, cam.bf / cam.fx)
            for lo, hi in zip(bounds[:-1], bounds[1:])]


def render_loop_stereo(
    n_frames: int,
    cam: PinholeCamera,
    radius: float,
    revolutions: float,
    n_landmarks: int = 6000,
    seed: int = 0,
    workers: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """The stereo loop sequence that tools/make_synth_data.py's `kitti`
    writes as PNG files (one lap of radius `radius` per
    n_frames / revolutions frames, `n_landmarks` quads, the right camera
    at cam.bf / cam.fx), rendered into memory: (poses [n, 4, 4] Tcw,
    images [n, 2, H, W] uint8, left then right). With workers > 1 a
    pool of spawned processes renders chunks of at most 16 frames, each
    worker rebuilding the scene from the seed, and every worker is
    joined before this returns."""
    poses = make_loop_trajectory(n_frames, radius, revolutions)
    images = np.empty((n_frames, 2, cam.height, cam.width), np.uint8)
    jobs = loop_chunk_jobs(n_frames, cam, radius, revolutions, n_landmarks, seed)
    if workers > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(max_workers=workers,
                                 mp_context=mp.get_context("spawn")) as pool:
            results = pool.map(_render_loop_chunk, jobs)
            for lo, chunk in results:
                images[lo : lo + len(chunk)] = chunk
    else:
        for job in jobs:
            lo, chunk = _render_loop_chunk(job)
            images[lo : lo + len(chunk)] = chunk
    return poses, images


def synthetic_ba_problem(n_cams: int, n_pts: int, obs_per_pt: int, seed: int = 0,
                         device: torch.device | str = "cuda"):
    """A KITTI-shaped bundle problem with no dataset: cameras along a
    forward path with a gentle yaw, stereo-scale points ahead of them,
    observations projected from the truth with 0.5 px noise and a
    perturbed start, camera 0 fixed. The JAX package's generator, draw
    for draw; the arrays go to `device` (the card unless the caller asks
    for another). Returns (BAProblem, PinholeCamera)."""
    from orb_slam2_test_tpu_torch.solvers.ba_core import BAProblem

    rng = np.random.default_rng(seed)
    fx = fy = 718.856
    cx, cy = 607.19, 185.22
    bf = fx * 0.53716
    cam = PinholeCamera(fx=fx, fy=fy, cx=cx, cy=cy, width=1241, height=376, bf=bf)

    t = np.arange(n_cams, dtype=np.float64)
    yaw = 0.002 * t
    cw = np.stack([np.cumsum(np.sin(yaw)), np.zeros(n_cams), np.cumsum(np.cos(yaw))], axis=1)
    Tcw_gt = np.tile(np.eye(4), (n_cams, 1, 1))
    for i in range(n_cams):
        c, s = np.cos(yaw[i]), np.sin(yaw[i])
        R = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
        Tcw_gt[i, :3, :3] = R
        Tcw_gt[i, :3, 3] = -R @ cw[i]

    anchor = rng.integers(0, n_cams, size=n_pts)
    X = cw[anchor] + rng.normal(0, 1, (n_pts, 3)) * [8, 2, 0] + \
        np.stack([np.sin(yaw[anchor]), np.zeros(n_pts), np.cos(yaw[anchor])], 1) \
        * rng.uniform(5, 40, (n_pts, 1))

    oc = (anchor[:, None] + np.arange(obs_per_pt)[None, :]) % n_cams
    op = np.broadcast_to(np.arange(n_pts)[:, None], oc.shape)
    oc, op = oc.ravel(), op.ravel().copy()
    Xc = np.einsum("oij,oj->oi", Tcw_gt[oc, :3, :3], X[op]) + Tcw_gt[oc, :3, 3]
    z = np.maximum(Xc[:, 2], 0.5)
    u = fx * Xc[:, 0] / z + cx + rng.normal(0, 0.5, len(oc))
    v = fy * Xc[:, 1] / z + cy + rng.normal(0, 0.5, len(oc))
    ur = u - bf / z + rng.normal(0, 0.5, len(oc))
    valid = (Xc[:, 2] > 0.5) & (np.abs(u - cx) < 900) & (np.abs(v - cy) < 300)

    Tcw0 = Tcw_gt.copy()
    Tcw0[:, :3, 3] += rng.normal(0, 0.05, (n_cams, 3))
    X0 = X + rng.normal(0, 0.05, X.shape)
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True

    def dev(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    prob = BAProblem(
        cam_Tcw=dev(Tcw0, np.float32),
        cam_fixed=dev(fixed),
        pt_xyz=dev(X0, np.float32),
        pt_valid=dev(np.ones(n_pts, bool)),
        obs_cam=dev(oc, np.int32),
        obs_pt=dev(op, np.int32),
        obs_uvr=dev(np.stack([u, v, ur], 1), np.float32),
        obs_isig2=dev(np.ones(len(oc), np.float32)),
        obs_valid=dev(valid),
    )
    return prob, cam
