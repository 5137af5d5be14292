"""Synthetic scenes and image sequences with exact ground truth.

A copy of the parts of orb_slam2_test_tpu/utils/synthetic.py that the
sequences need (`default_camera`, `make_landmarks`, `_landmark_patches`,
`render_frame`, `make_sequence`), with the port's camera and `se3_exp`:
random 3D landmarks rendered as textured planar quads, seen from known
camera trajectories. Rendering is NumPy on the host.
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
