"""The port's host side against the JAX package's, on the CPU: the copied
host modules, checkpoints across the two packages, the System facade,
and the CLI on the synthetic TUM mono recipe of
.claude/skills/verify/SKILL.md.

- settings parsed from every configs/*.yaml, the trajectory files (TUM
  and KITTI, written and read back), ATE and RPE, the synthetic
  sequence and the TUM list loader: equal to the JAX package's (the
  sequence's poses within 1e-6: se3_exp in float32 in both);
- a checkpoint written by the JAX package loads into the port with every
  map field and the host state equal, and the reverse; a smaller
  tracker grows to the checkpoint's capacity;
- the CLI (`python -m orb_slam2_test_tpu_torch.cli mono_tum`, --device
  cpu) on the recipe's 15 frames: >= 4 keyframes, 0 lost, an ATE within
  max(10%, 1 cm) of the JAX System's on the same files (the two draw
  their RANSAC samples from different generators); after
  --load-checkpoint --localization-only the keyframe count stays frozen
  (the stereo and RGB-D drivers: tests/test_torch_cli.py).
"""

import dataclasses
import json
import os
import re

import cv2
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.engine import tracking as jtracking
from orb_slam2_test_tpu.evaluation import ate as jate
from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_test_tpu.io import checkpoint as jckpt
from orb_slam2_test_tpu.io import datasets as jdatasets
from orb_slam2_test_tpu.io import settings as jsettings
from orb_slam2_test_tpu.io import trajectory as jtraj
from orb_slam2_test_tpu.slam_map import mapstate as jms
from orb_slam2_test_tpu.system import MONOCULAR
from orb_slam2_test_tpu.system import System as JSystem
from orb_slam2_test_tpu.utils import synthetic as jsynth
from orb_slam2_test_tpu_torch import cli, entry
from orb_slam2_test_tpu_torch.engine import tracking as ttracking
from orb_slam2_test_tpu_torch.evaluation import ate as tate
from orb_slam2_test_tpu_torch.geometry.se3 import se3_exp
from orb_slam2_test_tpu_torch.io import checkpoint as tckpt
from orb_slam2_test_tpu_torch.io import datasets as tdatasets
from orb_slam2_test_tpu_torch.io import settings as tsettings
from orb_slam2_test_tpu_torch.io import trajectory as ttraj
from orb_slam2_test_tpu_torch.system import System
from orb_slam2_test_tpu_torch.utils import synthetic as tsynth

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(f for f in os.listdir(os.path.join(ROOT, "configs")) if f.endswith(".yaml"))
STEP = np.array([0.12, 0.01, 0.0, 0.001, 0.003, 0.001])
# the tracker overrides of SKILL.md's step 2
OVERRIDES = dict(min_init_matches=40, min_init_triangulated=30, min_local_inliers=20,
                 n_triangulate_neighbors=2, ba_fixed_cap=4, max_frames_between_kf=4)


def _fields_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, dict):
            assert x.keys() == y.keys(), f.name
            for k in x:
                np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]), err_msg=k)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("name", CONFIGS)
def test_settings_match_jax(name):
    path = os.path.join(ROOT, "configs", name)
    j, t = jsettings.load_settings(path), tsettings.load_settings(path)
    _fields_equal(t, j)
    assert tuple(t.camera) == tuple(j.camera)
    assert dataclasses.asdict(t.tracker_config(seed=3)) == dataclasses.asdict(
        j.tracker_config(seed=3))


def test_settings_round_trip(tmp_path):
    s = tsettings.SlamSettings(fx=300.0, width=320, height=240, n_features=400,
                               min_init_matches=40, max_frames_between_kf=4)
    tsettings.save_settings(s, tmp_path / "t.yaml")
    jsettings.save_settings(jsettings.SlamSettings(**dataclasses.asdict(s)), tmp_path / "j.yaml")
    assert (tmp_path / "t.yaml").read_text() == (tmp_path / "j.yaml").read_text()
    _fields_equal(tsettings.load_settings(str(tmp_path / "t.yaml")),
                  jsettings.load_settings(str(tmp_path / "j.yaml")))


def _random_traj(rng, n, t0=0.0):
    out = []
    for i in range(n):
        T = np.asarray(se3_exp(torch.tensor(rng.normal(0, 0.3, 6))), np.float64)
        out.append((t0 + 0.1 * i, T))
    return out


def test_trajectory_files_and_ate_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    est = _random_traj(rng, 40, 1000.0)
    for save in ("save_trajectory_tum", "save_trajectory_kitti"):
        getattr(ttraj, save)(tmp_path / "t.txt", est)
        getattr(jtraj, save)(tmp_path / "j.txt", est)
        assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    ttraj.save_trajectory_tum(tmp_path / "t.txt", est)
    for a, b in zip(ttraj.load_trajectory_tum(tmp_path / "t.txt"),
                    jtraj.load_trajectory_tum(tmp_path / "t.txt")):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
    gt = [(t, np.linalg.inv(T) @ np.asarray(se3_exp(torch.tensor(
        rng.normal(0, 0.01, 6))), np.float64)) for t, T in est]
    for scale in (False, True):
        assert tate.absolute_trajectory_error(est, gt, with_scale=scale) == \
            jate.absolute_trajectory_error(est, gt, with_scale=scale)
    assert tate.relative_pose_error(est, gt, delta=3) == jate.relative_pose_error(est, gt, delta=3)


def test_synthetic_sequence_matches_jax():
    cam_t, cam_j = tsynth.default_camera(320, 240), jsynth.default_camera(320, 240)
    assert tuple(cam_t) == tuple(cam_j)
    _, pt, lt, it = tsynth.make_sequence(np.random.default_rng(0), 4, cam_t, 160, STEP)
    _, pj, lj, ij = jsynth.make_sequence(np.random.default_rng(0), 4, cam_j, 160, STEP)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_allclose(pt, pj, atol=1e-6)
    for a, b in zip(it, ij):
        assert np.abs(a - b).mean() < 0.05 and np.abs(a - b).max() < 20.0


def _write_tum_recipe(d, n=15):
    """SKILL.md's synthetic TUM mono dataset: PNGs, rgb.txt,
    groundtruth.txt and a settings file with its tracker overrides."""
    cam = tsynth.default_camera(320, 240)
    cam, poses_gt, _, images = tsynth.make_sequence(
        np.random.default_rng(0), n, cam=cam, n_landmarks=160, step=STEP)
    os.makedirs(os.path.join(d, "rgb"), exist_ok=True)
    rows = []
    for i, im in enumerate(images):
        ts = 1000.0 + 0.1 * i
        p = f"rgb/{ts:.6f}.png"
        cv2.imwrite(os.path.join(d, p), np.clip(im, 0, 255).astype(np.uint8))
        rows.append(f"{ts:.6f} {p}")
    with open(os.path.join(d, "rgb.txt"), "w") as f:
        f.write("# c\n# t f\n" + "\n".join(rows) + "\n")
    ttraj.save_trajectory_tum(os.path.join(d, "groundtruth.txt"),
                              [(1000.0 + 0.1 * i, poses_gt[i]) for i in range(n)])
    s = tsettings.SlamSettings(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=320,
                               height=240, fps=10.0, n_features=400, max_keyframes=32,
                               max_points=4096, **OVERRIDES)
    path = os.path.join(d, "synthetic.yaml")
    tsettings.save_settings(s, path)
    return path


def _cli(capsys, *argv):
    assert cli.main(list(argv)) == 0
    out = capsys.readouterr().out
    n_kf = int(re.search(r"keyframes: (\d+)", out).group(1))
    lost = int(re.search(r"lost frames: (\d+)", out).group(1))
    ate = re.search(r"ATE RMSE: (\S+) m", out)
    return n_kf, lost, float(ate.group(1)) if ate else None


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tumseq"))
    return d, _write_tum_recipe(d)


def test_cli_runs_the_tum_mono_recipe(recipe, capsys):
    d, settings = recipe
    out = os.path.join(d, "out")
    os.makedirs(out, exist_ok=True)
    gt = os.path.join(d, "groundtruth.txt")
    n_kf, lost, ate = _cli(
        capsys, "mono_tum", settings, d, "--device", "cpu", "--groundtruth", gt,
        "--traj-out", os.path.join(out, "traj.txt"), "--kf-traj-out",
        os.path.join(out, "kf.txt"), "--checkpoint-out", os.path.join(out, "map.npz"),
        "--diag", os.path.join(out, "diag.jsonl"),
    )
    # the JAX System on the same files
    js = JSystem(settings, MONOCULAR, vocabulary=None)
    for ts, img in jdatasets.load_tum_mono(d):
        js.track_monocular(img, ts)
    jres = jate.absolute_trajectory_error(
        js.tracker.export_trajectory(), jtraj.load_trajectory_tum(gt), with_scale=True)
    print(f"CLI: {n_kf} keyframes, {lost} lost, ATE {ate:.4f} m; JAX System: "
          f"{js.tracker.stats['n_kf']} keyframes, ATE {jres['rmse']:.4f} m")
    assert n_kf >= 4 and lost == 0
    assert np.isfinite(ate) and abs(ate - jres["rmse"]) <= max(0.1 * jres["rmse"], 0.01)
    assert len(ttraj.load_trajectory_tum(os.path.join(out, "traj.txt"))) >= 12
    assert len(open(os.path.join(out, "diag.jsonl")).readlines()) == 15

    # localization only, from the checkpoint: the map stays frozen
    n_kf2, _, _ = _cli(
        capsys, "mono_tum", settings, d, "--device", "cpu", "--load-checkpoint",
        os.path.join(out, "map.npz"), "--localization-only", "--traj-out",
        os.path.join(out, "traj2.txt"), "--kf-traj-out", os.path.join(out, "kf2.txt"),
    )
    assert n_kf2 == n_kf


def test_memory_sequence_drives_run(recipe):
    d, settings = recipe
    seq_files = tdatasets.load_tum_mono(d)
    jseq = jdatasets.load_tum_mono(d)
    assert [(i.timestamp, i.paths) for i in seq_files.items] == \
        [(i.timestamp, i.paths) for i in jseq.items]
    frames = [seq_files.load(it) for it in seq_files.items[:6]]
    seq = tdatasets.MemorySequence("mono", frames)
    system = System(settings, "monocular", device="cpu")
    out = os.path.join(d, "mem")
    os.makedirs(out, exist_ok=True)
    args = cli.common_parser("").parse_args(
        [settings, d, "--traj-out", os.path.join(out, "t.txt"),
         "--kf-traj-out", os.path.join(out, "k.txt")])
    summary = cli.run(system, seq, args, log=lambda *a: None)
    assert summary["frames"] == 6 and summary["lost_frames"] == 0
    assert summary["keyframes"] >= 2 and system.tracking_state == "OK"


def test_run_summary_records_loops_and_growth(recipe):
    """cli.run prints the loop count and returns it, with the capacity
    growths the Tracker made (a map of 4 keyframe slots grows on the
    recipe's sequence), as the JAX run's summary.json records them."""
    d, settings = recipe
    seq_files = tdatasets.load_tum_mono(d)
    seq = tdatasets.MemorySequence("mono", [seq_files.load(it) for it in seq_files.items])
    system = System(settings, "monocular", device="cpu", max_keyframes=4)
    out = os.path.join(d, "grow")
    os.makedirs(out, exist_ok=True)
    args = cli.common_parser("").parse_args(
        [settings, d, "--traj-out", os.path.join(out, "t.txt"),
         "--kf-traj-out", os.path.join(out, "k.txt")])
    lines = []
    summary = cli.run(system, seq, args, log=lines.append)
    assert any("loops: 0" in line for line in lines)
    assert summary["loops"] == 0 and summary["relocs"] == 0
    events = summary["capacity_growth_events"]
    assert events and events[0]["cap_kf"] == 8 and events[0]["cap_pt"] == 4096
    assert 0 < events[0]["frame"] < summary["frames"]
    assert system.tracker.cfg.max_keyframes == events[-1]["cap_kf"]


def _bench_tracker_map(cfg):
    return entry.bench_map(cfg, 5, 300, seed=2)


def _host_state(tr):
    return dict(state=tr.state, ref_kf=int(tr.ref_kf), frame_id=tr.frame_id, stats=tr.stats,
                ts0=tr._ts0, traj=[(t, np.asarray(T).tolist()) for t, T in tr.trajectory],
                rel=[(t, int(r), np.asarray(T).tolist()) for t, r, T in tr.rel_trajectory],
                n_live_kf=tr.n_live_kf)


def _fill_host_state(tr, rng):
    tr.state = "OK"
    tr.ref_kf, tr.frame_id, tr._ts0 = 3, 9, 1000.0
    tr.stats = {"n_kf": 5, "reloc": 0, "lost_frames": 1, "loops": 0}
    tr.trajectory = [(1000.0 + i, np.eye(4) + i) for i in range(3)]
    tr.rel_trajectory = [(1000.0 + i, i, np.eye(4) * (i + 1)) for i in range(3)]
    tr.last_Tcw = np.asarray(se3_exp(torch.tensor(rng.normal(0, 0.1, 6))))


def test_checkpoint_from_jax_loads_into_the_port(tmp_path):
    cfg = ttracking.TrackerConfig(n_features=64, max_keyframes=8, max_points=512)
    m = _bench_tracker_map(cfg)
    cam = entry.CAM
    jtr = jtracking.Tracker(JCam(**cam._asdict()),
                            jtracking.TrackerConfig(**dataclasses.asdict(cfg)))
    jtr.map = jms.MapState(**{k: jnp.asarray(v) for k, v in m.items()})
    _fill_host_state(jtr, np.random.default_rng(0))
    jckpt.save_tracker(str(tmp_path / "j.npz"), jtr)

    ttr = ttracking.Tracker(cam, cfg, device="cpu")
    tckpt.load_tracker(str(tmp_path / "j.npz"), ttr)
    out = entry.map_to_numpy(ttr.map)
    for name in m:
        np.testing.assert_array_equal(out[name], m[name], err_msg=name)
    assert ttr.map.kf_desc.dtype == torch.int32
    jtr.n_live_kf = int(np.sum(m["kf_valid"]))
    assert _host_state(ttr) == _host_state(jtr)

    # a smaller tracker grows to the checkpoint's capacity
    small = ttracking.Tracker(cam, dataclasses.replace(cfg, max_keyframes=4, max_points=256),
                              device="cpu")
    tckpt.load_tracker(str(tmp_path / "j.npz"), small)
    assert small.cap == cfg.map_capacity
    np.testing.assert_array_equal(small.map.pt_xyz.numpy(), m["pt_xyz"])


def test_checkpoint_from_the_port_loads_into_jax(tmp_path):
    cfg = ttracking.TrackerConfig(n_features=64, max_keyframes=8, max_points=512)
    m = _bench_tracker_map(cfg)
    ttr = ttracking.Tracker(entry.CAM, cfg, device="cpu")
    ttr.map = entry.map_from_numpy(m, "cpu")
    _fill_host_state(ttr, np.random.default_rng(1))
    tckpt.save_tracker(str(tmp_path / "t.npz"), ttr)

    jtr = jtracking.Tracker(JCam(**entry.CAM._asdict()),
                            jtracking.TrackerConfig(**dataclasses.asdict(cfg)))
    jckpt.load_tracker(str(tmp_path / "t.npz"), jtr)
    for name in m:
        np.testing.assert_array_equal(np.asarray(getattr(jtr.map, name)), m[name], err_msg=name)
    assert np.asarray(jtr.map.pt_desc).dtype == np.uint32
    ttr.n_live_kf = int(np.sum(m["kf_valid"]))
    assert _host_state(jtr) == _host_state(ttr)


def test_system_checkpoint_round_trip_and_vocabulary(recipe, tmp_path):
    d, settings = recipe
    s = tsettings.load_settings(settings)
    system = System(s, "monocular", device="cpu")
    for ts, img in list(tdatasets.load_tum_mono(d))[:8]:
        system.track_monocular(img, ts)
    system.save_checkpoint(str(tmp_path / "m.npz"))
    again = System(s, "monocular", device="cpu")
    again.load_checkpoint(str(tmp_path / "m.npz"))
    np.testing.assert_array_equal(again.tracker.map.kf_Tcw.numpy(),
                                  system.tracker.map.kf_Tcw.numpy())
    assert again.tracker.n_live_kf == system.tracker.n_live_kf >= 2
    assert system.timing_stats()["n"] == 8
    # the packaged vocabulary attaches place recognition; mono leaves the
    # Sim3 scale free (reference bFixScale = sensor != MONOCULAR)
    voc_system = System(s, "monocular", vocabulary="default", device="cpu")
    closer = voc_system.tracker.loop_closer
    assert closer is not None and closer.fix_scale is False
    assert voc_system.vocabulary.n_words >= 500_000 and closer.voc is voc_system.vocabulary
    # a checkpoint loaded into it rebuilds the keyframe database
    voc_system.load_checkpoint(str(tmp_path / "m.npz"))
    assert set(closer.db.words) == set(np.flatnonzero(again.tracker.map.kf_valid.numpy()))
    with pytest.raises(RuntimeError):
        system.track_stereo(None, None, 0.0)



def test_cli_vocabulary_options(recipe, tmp_path):
    """--vocabulary defaults to the packaged artifact and takes a path (a
    small npz here); --no-vocabulary turns place recognition off. The
    System attaches what the option names."""
    from orb_slam2_test_tpu_torch.bow import vocabulary as tvoc

    d, settings = recipe
    p = cli.common_parser("")
    assert p.parse_args([settings, d]).vocabulary == "default"
    assert p.parse_args([settings, d, "--no-vocabulary"]).vocabulary is None
    train = np.random.default_rng(0).integers(0, 2**32, (500, 8), dtype=np.uint32)
    path = str(tmp_path / "small.npz")
    tvoc.save_vocabulary_npz(tvoc.build_vocabulary(train, k=4, depth=2), path)
    args = p.parse_args([settings, d, "--vocabulary", path])
    system = System(settings, "monocular", vocabulary=args.vocabulary, device="cpu")
    assert system.tracker.loop_closer.voc is system.vocabulary
    assert system.vocabulary.n_words <= 16 and not system.tracker.loop_closer.fix_scale
    assert System(settings, "monocular", vocabulary=None, device="cpu").tracker.loop_closer is None


def test_system_viewers_on_the_cpu(recipe, tmp_path):
    """System(use_viewer=True) writes PNG snapshots every `every` frames
    and a final pair at shutdown; System(live_viewer_port=0) serves the
    map while tracking and stops its server at shutdown. The viewer runs
    after the timed call: each frame is timed once."""
    import urllib.request

    d, settings = recipe
    frames = list(tdatasets.load_tum_mono(d))[:6]
    out = str(tmp_path / "viewer")
    system = System(settings, "monocular", device="cpu", use_viewer=True, viewer_dir=out)
    system.viewer.every = 2
    for ts, img in frames:
        system.track_monocular(img, ts)
    system.shutdown()
    assert system.timing_stats()["n"] == 6
    assert sorted(os.listdir(out)) == [
        "frame_000002.png", "frame_000004.png", "frame_000006.png", "frame_final.png",
        "map_000002.png", "map_000004.png", "map_000006.png", "map_final.png"]

    live = System(settings, "monocular", device="cpu", live_viewer_port=0, use_viewer=True)
    viewer = live.viewer
    assert type(viewer).__name__ == "LiveViewer"  # the live viewer comes first
    viewer.every = 2
    for ts, img in frames:
        live.track_monocular(img, ts)
    with urllib.request.urlopen(f"http://127.0.0.1:{viewer.port}/state.json", timeout=10) as r:
        state = json.loads(r.read())
    assert state["frame"] == 6 and state["state"] == live.tracking_state == "OK"
    assert len(state["kf"]) == int(live.tracker.map.kf_valid.sum()) >= 2
    assert len(state["traj"]) == len(live.tracker.trajectory)
    live.shutdown()
    assert not viewer._thread.is_alive()


def test_trace_window_and_profile_scope():
    """--device-trace's frames are the JAX driver's (examples/_runner.py:
    min(20, n // 2) up to min(40, n - 1)); a live stream, of no known
    length, traces 20-40. --profile empties the profiler, prints its
    report at the end and turns it off again."""
    from orb_slam2_test_tpu_torch.utils.profiling import profiler

    for n in (1, 8, 41, 100):
        assert cli._trace_window(n) == (min(20, n // 2), min(40, n - 1))
    assert cli._trace_window() == cli.TRACE_WINDOW == (20, 40)
    assert not profiler.enabled
    profiler.enable()
    profiler.add("stale", 1.0)
    profiler.disable()
    logs = []
    with cli._profiled(True, logs.append):
        assert profiler.enabled and "stale" not in profiler.report()
        with profiler.span("stage"):
            pass
    assert not profiler.enabled
    assert "stage" in logs[-1] and "stale" not in logs[-1]
    with cli._profiled(False, logs.append):
        assert not profiler.enabled
    assert len(logs) == 2


def test_cli_profile_trace_and_live_viewer(recipe, tmp_path, capsys):
    """mono_tum with --profile prints the Tracker's stage table at exit,
    --device-trace writes a trace of the frame window, --live-viewer 0
    serves on a free port."""
    from orb_slam2_test_tpu_torch.utils import profiling

    d, settings = recipe
    trace = str(tmp_path / "trace")
    assert cli.main([
        "mono_tum", settings, d, "--device", "cpu", "--no-vocabulary", "--max-frames", "8",
        "--profile", "--device-trace", trace, "--live-viewer", "0",
        "--traj-out", str(tmp_path / "t.txt"), "--kf-traj-out", str(tmp_path / "k.txt"),
    ]) == 0
    # the run turns the profiler off again; its samples stay until the next run
    assert not profiling.profiler.enabled
    report = profiling.profiler.report()
    out = capsys.readouterr().out
    assert "live viewer: http://localhost:" in out
    assert "median ms" in out and "frame_build" in out
    assert report["frame_build"]["count"] + report.get("track_frame_fused", {"count": 0})[
        "count"] == 8
    with open(os.path.join(trace, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert sum(str(e.get("name")).startswith("aten::") for e in events) > 1000
