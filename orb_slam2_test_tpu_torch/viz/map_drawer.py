"""MapDrawer: render map points, keyframes, the covisibility graph and
the frame trajectory (reference src/MapDrawer.cc DrawMapPoints /
DrawKeyFrames / DrawCurrentCamera: Pangolin GL there, matplotlib Agg
here).

A copy of orb_slam2_test_tpu/viz/map_drawer.py on the port's MapState:
the map's fields are read back once per draw, and the covisibility rows
come from `slam_map.covisibility.covisibility_weights` on the map's
device."""

from __future__ import annotations

import numpy as np
import torch

from orb_slam2_test_tpu_torch.slam_map.covisibility import covisibility_weights
from orb_slam2_test_tpu_torch.viz.frame_drawer import host_array


def _camera_centers(Tcw: np.ndarray) -> np.ndarray:
    R = Tcw[:, :3, :3]
    t = Tcw[:, :3, 3]
    return -np.einsum("nij,nj->ni", R.transpose(0, 2, 1), t)


def draw_map(
    m,
    trajectory: list | None = None,
    path: str | None = None,
    axes: tuple = (0, 2),
    show_covisibility: bool = True,
    cov_threshold: int = 15,
):
    """Render the MapState. axes picks the 2D projection (default x-z,
    the ground plane for forward-moving cameras). Returns the matplotlib
    figure; saves it to `path` if given (and closes it)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    a0, a1 = axes
    fig, ax = plt.subplots(figsize=(8, 8))

    pts = host_array(m.pt_xyz)[host_array(m.pt_valid)]
    if len(pts):
        ax.scatter(
            pts[:, a0], pts[:, a1], s=1.0, c="#888888", linewidths=0,
            label=f"map points ({len(pts)})",
        )

    kf_mask = host_array(m.kf_valid)
    kf_T = host_array(m.kf_Tcw)[kf_mask]
    if len(kf_T):
        c = _camera_centers(kf_T)
        ax.scatter(
            c[:, a0], c[:, a1], s=18, c="#1167b1", marker="s",
            label=f"keyframes ({len(c)})",
        )
        if show_covisibility:
            kf_ids = np.nonzero(kf_mask)[0]
            W = host_array(covisibility_weights(
                m, torch.as_tensor(kf_ids, device=m.kf_valid.device)))  # [k, K]
            for i, ki in enumerate(kf_ids):
                for kj in np.nonzero(W[i] >= cov_threshold)[0]:
                    j = np.searchsorted(kf_ids, kj)
                    if j < len(kf_ids) and kf_ids[j] == kj and ki < kj:
                        ax.plot(
                            [c[i, a0], c[j, a0]], [c[i, a1], c[j, a1]],
                            c="#b3d4e8", lw=0.5, zorder=0,
                        )

    if trajectory:
        T = np.stack([host_array(t) for _, t in trajectory])
        tc = _camera_centers(T)
        ax.plot(
            tc[:, a0], tc[:, a1], c="#d62728", lw=1.0,
            label=f"trajectory ({len(tc)} frames)",
        )

    names = "xyz"
    ax.set_xlabel(names[a0])
    ax.set_ylabel(names[a1])
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    if path is not None:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig
