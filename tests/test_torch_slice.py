"""The port's tracking step against the JAX package, end to end.

- 320x240 / 300 features / 512 map points on a scene the frame
  observes: the port's `tracking_step` against the same three JAX calls
  (build_frame_mono, search_by_projection, pose_optimization); pose atol
  1e-4 (float32 rounding through 40 Gauss-Newton iterations), n_inliers
  within 1%.
- Full size, 640x480 / 1000 features / 2048 points:
  `__graft_entry__.tracking_step(*_example_args())` against the port fed
  the same arrays through `state_from_numpy`; keypoints equal, pose atol
  1e-4, n_inliers equal.
- The package never imports JAX, and chip_smoke.py fails without a card.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as graft
from orb_slam2_test_tpu.engine import matchers as jm
from orb_slam2_test_tpu.engine.frame import FrameData as JFrame
from orb_slam2_test_tpu.engine.frame import build_frame_mono as jbuild
from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_test_tpu.geometry.se3 import se3_exp
from orb_slam2_test_tpu.solvers.pose_opt import pose_optimization as jpose
from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.engine.frame import build_frame_mono as tbuild
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera as TCam

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _jax_tracking_step(cam, img, pts_xyz, pts_desc, pts_valid, pts_normal,
                       pts_mind, pts_maxd, Tcw_pred, n_features):
    """__graft_entry__.tracking_step with the camera and sizes as arguments."""
    frame = jbuild(img, 0.0, cam, n_features=n_features)
    pm = jm.search_by_projection(
        cam, Tcw_pred, pts_xyz, pts_desc, pts_valid, pts_normal,
        pts_mind, pts_maxd, jnp.arange(pts_xyz.shape[0], dtype=jnp.int32),
        frame, radius=15.0, check_view_cos=False,
    )
    has = pm.feat_pt >= 0
    X = pts_xyz[jnp.clip(pm.feat_pt, 0)]
    uvr = jnp.concatenate([frame.uv, frame.ur[:, None]], axis=-1)
    isig2 = 1.0 / (1.2 ** frame.level.astype(jnp.float32)) ** 2
    res = jpose(cam, Tcw_pred, X, uvr, isig2, has & frame.valid)
    return res.Tcw, res.n_inliers


def test_tracking_step_small_consistent_scene():
    rng = np.random.default_rng(11)
    h, w = 240, 320
    kw = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=w, height=h)
    img = rng.integers(0, 256, (h, w)).astype(np.uint8)
    jframe = jbuild(jnp.asarray(img), 0.0, JCam(**kw), n_features=300)
    frame_np = JFrame(*[np.asarray(x) for x in jframe])
    T_true = np.asarray(se3_exp(jnp.asarray([0.1, -0.05, 0.2, 0.02, -0.03, 0.01])))
    scene = entry.consistent_scene(rng, frame_np, TCam(**kw), 512, T_true)
    dT = np.asarray(se3_exp(jnp.asarray([0.02, -0.015, 0.015, 0.003, -0.003, 0.002])))
    T_pred = (dT @ T_true).astype(np.float32)

    jT, jn = _jax_tracking_step(
        JCam(**kw), jnp.asarray(img), *[jnp.asarray(a) for a in scene],
        jnp.asarray(T_pred), 300,
    )
    tT, tn = entry.tracking_step(
        *entry.state_from_numpy(img, *scene, T_pred, device="cpu"), cam=TCam(**kw), n_features=300
    )
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-4)
    assert abs(int(tn) - int(jn)) <= 0.01 * int(jn)
    # the scene is observed: most map points are inliers at ~T_true
    assert int(tn) >= 0.8 * scene[2].sum()
    assert np.abs(tT.numpy() - T_true)[:3, 3].max() < 1e-2


def test_tracking_step_full_size_matches_graft_entry():
    args = graft._example_args()
    jT, jn = graft.tracking_step(*args)
    state = entry.state_from_numpy(*[np.asarray(a) for a in args], device="cpu")
    tT, tn = entry.tracking_step(*state)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-4)
    assert int(tn) == int(jn)

    jf = jbuild(args[0], 0.0, graft.CAM, n_features=graft.N_FEATURES)
    tf = tbuild(state[0], 0.0, entry.CAM, n_features=entry.N_FEATURES)
    for field in ("uv", "level", "valid"):
        np.testing.assert_array_equal(
            getattr(tf, field).numpy(), np.asarray(getattr(jf, field)), err_msg=field
        )
    assert tuple(entry.CAM) == tuple(graft.CAM)
    assert (entry.N_FEATURES, entry.N_PTS) == (graft.N_FEATURES, graft.N_PTS)


def test_port_never_imports_jax():
    """Walking the package imports neither JAX nor the JAX package, nor
    PyYAML, OpenCV or matplotlib at module level (the card's machine has
    none of them)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import orb_slam2_test_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(','.join(names), 'jax' in sys.modules, "
        "any(m.startswith('orb_slam2_test_tpu.') for m in sys.modules), "
        "'yaml' in sys.modules, 'cv2' in sys.modules, 'matplotlib' in sys.modules)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    names, has_jax, has_jax_pkg, has_yaml, has_cv2, has_mpl = out.stdout.split()
    names = set(names.split(","))
    assert len(names) >= 40  # every subpackage and module was imported
    for mod in ("ops.stereo", "ops.matching", "slam_map.mapstate", "slam_map.covisibility",
                "engine.tracking", "engine.frame", "engine.matchers", "entry",
                "solvers.initializer", "io.settings", "io.datasets", "io.trajectory",
                "io.checkpoint", "evaluation.ate", "system", "cli", "utils.synthetic",
                "geometry.sim3", "solvers.sim3_solver", "solvers.pose_graph",
                "solvers.ba_core", "engine.loop_closing", "parallel", "parallel.dist_ba",
                "parallel.multi_map", "parallel.multihost", "io.live", "utils.profiling",
                "viz", "viz.live_viewer", "viz.map_drawer", "viz.frame_drawer", "viz.viewer",
                "viz.ar", "tools", "tools.make_synth_data", "tools.build_vocab",
                "tools.vocab_recall", "tools.ba_window_sweep"):
        assert "orb_slam2_test_tpu_torch." + mod in names
    assert has_jax == "False" and has_jax_pkg == "False"
    assert has_yaml == "False" and has_cv2 == "False" and has_mpl == "False"


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        cwd, script = tmp_path, tmp_path / "chip_smoke.py"
    else:
        cwd = ROOT
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, str(script)], cwd=cwd, capture_output=True, text=True,
        timeout=120, env=env,
    )
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    if lines:
        try:
            last = json.loads(lines[-1])
        except json.JSONDecodeError:
            last = None
        assert not (isinstance(last, dict) and last.get("ok") is True)
