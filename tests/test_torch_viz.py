"""The port's viewers (viz/) against the JAX package's, on the CPU.

- `draw_frame`, `draw_ar_frame` and `cube_vertices`: pixel-equal
  (values equal) to the JAX package's on the same inputs;
  `fit_plane_ransac`: the same plane, exactly, with the same seed, also
  from a tensor;
- `draw_map` on a bench map carried across by `entry.map_from_numpy`:
  the scatter offsets and the covisibility and trajectory line data of
  its figure equal the JAX figure's;
- `LiveViewer.refresh()`: the served state.json and frame.jpg are equal,
  byte for byte, to the JAX `LiveViewer`'s for the same map, trajectory
  and tracker fields (one duck-typed fake system, each package's map);
- HTTP: GET /, /state.json and /frame.jpg; POST /control on a port
  System: localization_on / off take effect at the next update, pause
  blocks until a resume from another thread, reset clears the map;
- `Viewer`: map_*.png and frame_*.png every `every` frames, and
  map_final.png / frame_final.png at close.
"""

import json
import os
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import torch

from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_test_tpu.slam_map import mapstate as jms
from orb_slam2_test_tpu.viz import ar as jar
from orb_slam2_test_tpu.viz import frame_drawer as jfd
from orb_slam2_test_tpu.viz import live_viewer as jlv
from orb_slam2_test_tpu.viz import map_drawer as jmd
from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.engine.tracking import TrackerConfig
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera as TCam
from orb_slam2_test_tpu_torch.io.settings import SlamSettings
from orb_slam2_test_tpu_torch.system import System
from orb_slam2_test_tpu_torch.viz import ar as tar
from orb_slam2_test_tpu_torch.viz import frame_drawer as tfd
from orb_slam2_test_tpu_torch.viz import live_viewer as tlv
from orb_slam2_test_tpu_torch.viz import map_drawer as tmd
from orb_slam2_test_tpu_torch.viz.viewer import Viewer

torch.set_num_threads(2)

CAM = dict(fx=100.0, fy=100.0, cx=32.0, cy=32.0, width=64, height=64)


def test_draw_frame_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(-20, 280, (48, 64)).astype(np.float32)
    uv = rng.uniform(-5, 70, (60, 2)).astype(np.float32)
    tracked = rng.uniform(size=60) < 0.5
    args = dict(state="OK", n_kf=7, n_pts=1234)
    j = jfd.draw_frame(img, uv, tracked, **args)
    t = tfd.draw_frame(img, uv, tracked, **args)
    assert t.dtype == np.uint8 and t.shape == (48 + 22, 64, 3)
    np.testing.assert_array_equal(t, j)


def _plane_points(rng):
    pts = rng.uniform(-0.3, 0.3, (200, 3))
    pts[:, 2] = 1.0 + rng.normal(0, 0.002, 200)
    return np.concatenate([pts, rng.uniform(-1, 1, (40, 3))])


def test_plane_cube_and_ar_frame_match_jax():
    pts = _plane_points(np.random.default_rng(3))
    jp = jar.fit_plane_ransac(pts, rng=np.random.default_rng(5))
    tp = tar.fit_plane_ransac(pts, rng=np.random.default_rng(5))
    # a float32 tensor, as tracked_world_points gives it, against its numpy copy
    t32 = torch.from_numpy(pts.astype(np.float32))
    tp32 = tar.fit_plane_ransac(t32, rng=np.random.default_rng(5))
    np32 = jar.fit_plane_ransac(pts.astype(np.float32), rng=np.random.default_rng(5))
    for a, b in ((tp, jp), (tp32, np32)):
        assert a.n_inliers == b.n_inliers and a.d == b.d
        for f in ("normal", "origin", "R_wp"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert tp.n_inliers >= 180
    np.testing.assert_array_equal(tar.cube_vertices(tp, 0.2), jar.cube_vertices(jp, 0.2))
    img = np.random.default_rng(1).uniform(0, 255, (64, 64)).astype(np.float32)
    uv = np.random.default_rng(2).uniform(0, 64, (30, 2))
    for plane_t, plane_j in ((tp, jp), (None, None)):
        t = tar.draw_ar_frame(img, np.eye(4), TCam(**CAM), plane_t, cube_size=0.2,
                              tracked_uv=uv)
        j = jar.draw_ar_frame(img, np.eye(4), JCam(**CAM), plane_j, cube_size=0.2,
                              tracked_uv=uv)
        np.testing.assert_array_equal(t, j)
    assert tar.fit_plane_ransac(torch.zeros((5, 3))) is None


def _bench(n_kf=6, n_pt=300):
    """A bench map (entry.bench_map: 400 features a keyframe, each
    linked to a random one of n_pt points with probability 1/2, so the
    covisibility weights straddle the live viewer's 100) in both
    packages."""
    arrays = entry.bench_map(TrackerConfig(n_features=400, max_keyframes=8, max_points=512),
                             n_kf, n_pt, seed=4)
    return (jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            entry.map_from_numpy(arrays, "cpu"))


def _trajectory(n=12):
    traj = []
    for i in range(n):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = (-0.1 * i, 0.01 * i, -0.05 * i)
        traj.append((1.76e9 + 0.1 * i, T))
    return traj


def test_draw_map_matches_jax():
    import matplotlib.pyplot as plt

    jm, tm = _bench()
    traj = _trajectory()
    figs = [jmd.draw_map(jm, trajectory=traj), tmd.draw_map(tm, trajectory=traj)]
    (jax_, tax) = (f.axes[0] for f in figs)
    assert len(tax.collections) == len(jax_.collections) == 2
    for a, b in zip(tax.collections, jax_.collections):
        np.testing.assert_array_equal(a.get_offsets(), b.get_offsets())
    assert len(tax.lines) == len(jax_.lines) > 2  # covisibility lines and the trajectory
    for a, b in zip(tax.lines, jax_.lines):
        np.testing.assert_array_equal(a.get_xydata(), b.get_xydata())
    assert [t.get_text() for t in tax.get_legend().get_texts()] == \
        [t.get_text() for t in jax_.get_legend().get_texts()]
    for f in figs:
        plt.close(f)


class _Tracker:
    """The fields of a Tracker that the viewers read."""

    def __init__(self, m, frame, cur_feat_pt, image, cam):
        self.map, self.last_frame, self.cur_feat_pt, self.last_image = m, frame, cur_feat_pt, image
        self.cam = cam
        self.state = "OK"
        self.localization_only = False
        self.frame_id = 12
        self.stats = {"n_kf": 6, "reloc": 0, "lost_frames": 0, "loops": 1}
        self.trajectory = _trajectory()
        self.last_Tcw = self.trajectory[-1][1]


class _System:
    def __init__(self, tracker):
        self.tracker = tracker


def _fake_systems():
    """One fake system per package over the same map and frame."""
    jm, tm = _bench()
    rng = np.random.default_rng(6)
    uv = rng.uniform(0, 64, (50, 2)).astype(np.float32)
    valid = rng.uniform(size=50) < 0.9
    feat = np.where(rng.uniform(size=50) < 0.5, rng.integers(0, 300, 50), -1).astype(np.int32)
    img = rng.uniform(0, 255, (64, 64)).astype(np.float32)

    class Frame:
        pass

    jf, tf = Frame(), Frame()
    jf.uv_raw, jf.valid = uv, valid
    tf.uv_raw, tf.valid = torch.from_numpy(uv), torch.from_numpy(valid)
    return (_System(_Tracker(jm, jf, feat, img, JCam(**CAM))),
            _System(_Tracker(tm, tf, torch.from_numpy(feat), torch.from_numpy(img),
                             TCam(**CAM))))


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.read()


def _post(port, action):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/control",
                                 data=json.dumps({"action": action}).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status


def test_live_viewer_state_matches_jax_and_serves_it():
    jsys, tsys = _fake_systems()
    jv, tv = jlv.LiveViewer(jsys, port=0), tlv.LiveViewer(tsys, port=0)
    try:
        jv.refresh()
        tv.refresh()
        assert tv._state_json == jv._state_json
        assert tv._frame_jpg == jv._frame_jpg and len(tv._frame_jpg) > 100
        state = json.loads(tv._state_json)
        assert len(state["kf"]) == 6 and len(state["points"]) == 300
        assert 0 < len(state["edges"]) < 15 and len(state["tree"]) == 5
        assert set(tv.last_refresh_s) == {"readback", "covisibility", "json", "frame", "total"}
        status, html = _get(tv.port, "/")
        assert status == 200 and b"Viewer" in html
        status, body = _get(tv.port, "/state.json")
        assert status == 200 and body == tv._state_json
        status, jpg = _get(tv.port, "/frame.jpg?3")
        assert status == 200 and jpg == tv._frame_jpg
    finally:
        jv.close()
        tv.close()


def test_live_viewer_controls_on_a_system():
    s = SlamSettings(fx=256.0, fy=256.0, cx=160.0, cy=120.0, width=320, height=240,
                     n_features=200, max_keyframes=8, max_points=1024)
    system = System(s, "monocular", device="cpu", live_viewer_port=0)
    v = system.viewer
    try:
        assert isinstance(v, tlv.LiveViewer) and v.port > 0
        _post(v.port, "localization_on")
        assert not system.tracker.localization_only  # queued until the next update
        v.update()
        assert system.tracker.localization_only
        _post(v.port, "localization_off")
        v.update()
        assert not system.tracker.localization_only

        _post(v.port, "pause")

        def resume():
            time.sleep(0.3)
            _post(v.port, "resume")

        t = threading.Thread(target=resume)
        t.start()
        t0 = time.monotonic()
        v.update()
        t.join()
        assert time.monotonic() - t0 >= 0.25 and not v.paused

        system.tracker.stats["n_kf"] = 3
        system.tracker.state = "OK"
        _post(v.port, "reset")
        v.update()
        assert system.tracker.stats["n_kf"] == 0 and system.tracker.state == "NOT_INITIALIZED"
    finally:
        system.shutdown()
    assert not v._thread.is_alive()


def test_viewer_writes_snapshots(tmp_path):
    _, tsys = _fake_systems()
    out = str(tmp_path / "viewer")
    v = Viewer(tsys, out_dir=out, every=2)
    for _ in range(5):
        v.update()
    v.close()
    assert sorted(os.listdir(out)) == [
        "frame_000002.png", "frame_000004.png", "frame_final.png",
        "map_000002.png", "map_000004.png", "map_final.png"]


def test_cli_ar_writes_overlays(tmp_path, capsys):
    """`cli.py ar` over the SKILL.md TUM recipe: one BGR overlay per
    frame; frames tracked OK get a plane fitted to their tracked points
    when there are enough of them."""
    import cv2

    from orb_slam2_test_tpu_torch import cli

    from test_torch_system import _write_tum_recipe

    d = str(tmp_path / "recipe")
    settings = _write_tum_recipe(d, n=8)
    out = str(tmp_path / "ar")
    assert cli.main(["ar", settings, d, "--device", "cpu", "--no-vocabulary", "--out", out,
                     "--refit-every", "2"]) == 0
    names = sorted(os.listdir(out))
    assert names == [f"ar_{i:06d}.png" for i in range(8)]
    img = cv2.imread(os.path.join(out, names[-1]))
    assert img.shape == (240, 320, 3)
    assert "8 AR frames written" in capsys.readouterr().out
