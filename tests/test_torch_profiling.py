"""The port's stage profiler and device trace (utils/profiling.py)
against the JAX package's, on the CPU.

- `StageProfiler` on the same `add` samples: the report's keys, order,
  counts and statistics and the formatted table, exactly; disabled, a
  no-op;
- the Tracker's spans: on tests/test_profiling.py's 3-frame mono
  sequence (the port replaying the JAX package's RANSAC draws) and on
  tests/test_torch_tracker_stereo.py's 6-frame stereo band sequence,
  the port's Tracker records the same span names with the same counts
  as the JAX Tracker;
- `device_trace` on the CPU writes a Chrome trace that holds an
  `annotate` range.
"""

import json
import os

import numpy as np
import torch

from orb_slam2_test_tpu.engine import tracking as jtracking
from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_test_tpu.utils import profiling as jprof
from orb_slam2_test_tpu.utils.synthetic import default_camera, make_sequence
from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.engine import tracking as ttracking
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera as TCam
from orb_slam2_test_tpu_torch.utils import profiling as tprof

from test_torch_tracker import Replay, run_tracker

torch.set_num_threads(2)


def test_stage_profiler_matches_jax():
    rng = np.random.default_rng(0)
    samples = [(str(rng.choice(["frame_build", "track_local_map", "keyframe_insert", "x"])),
                float(rng.exponential(0.01))) for _ in range(200)]
    j, t = jprof.StageProfiler(enabled=True), tprof.StageProfiler(enabled=True)
    for name, s in samples:
        j.add(name, s)
        t.add(name, s)
    assert list(t.report().items()) == list(j.report().items())
    assert t.format_report() == j.format_report()
    t.clear()
    assert t.report() == {}


def test_disabled_profiler_is_a_noop():
    p = tprof.StageProfiler(enabled=False)
    with p.span("x"):
        pass
    p.add("y", 1.0)
    assert p.report() == {}
    p.enable()
    with p.span("x"):
        pass
    assert p.report()["x"]["count"] == 1


def test_env_enables_the_profiler(monkeypatch):
    monkeypatch.setenv("ORB_TPU_PROFILE", "1")
    assert tprof.StageProfiler().enabled and jprof.StageProfiler().enabled
    monkeypatch.setenv("ORB_TPU_PROFILE", "0")
    assert not tprof.StageProfiler().enabled and not jprof.StageProfiler().enabled


def _spans(prof, run):
    """{span: count} recorded by `run()` on the module profiler `prof`."""
    prof.profiler.enable()
    prof.profiler.clear()
    try:
        run()
        return {k: v["count"] for k, v in prof.profiler.report().items()}
    finally:
        prof.profiler.disable()
        prof.profiler.clear()


def test_tracker_spans_match_jax_mono():
    """tests/test_profiling.py's sequence and tracker configuration."""
    cam, _, _, images = make_sequence(
        np.random.default_rng(0), 3, cam=default_camera(320, 240), n_landmarks=80,
        step=np.array([0.1, 0.0, 0.0, 0.0, 0.0, 0.0]))
    cfg = dict(n_features=200, max_keyframes=8, max_points=1024)
    jtr = jtracking.Tracker(cam, jtracking.TrackerConfig(**cfg))
    ttr = Replay(TCam(**cam._asdict()), ttracking.TrackerConfig(**cfg), device="cpu")
    j = _spans(jprof, lambda: run_tracker(jtr, images))
    t = _spans(tprof, lambda: run_tracker(ttr, images))
    print(f"mono spans: port {t}, JAX {j}")
    assert t == j
    assert t["frame_build"] == 3
    assert ttr.state == jtr.state


def test_tracker_spans_match_jax_stereo():
    """The stereo band sequence of tests/test_torch_tracker_stereo.py:
    depth initialization, then tracked frames with keyframe decisions."""
    from test_torch_tracker_stereo import CAM, CFG

    seq = entry.band_sequence(np.random.default_rng(0), CAM, 6, "cpu")
    views = [(left.numpy(), right.numpy()) for _, left, right in seq.frames]
    jtr = jtracking.Tracker(JCam(**CAM._asdict()), jtracking.TrackerConfig(**CFG))
    ttr = ttracking.Tracker(CAM, ttracking.TrackerConfig(**CFG), device="cpu")
    j = _spans(jprof, lambda: run_tracker(jtr, views, mono=False))
    t = _spans(tprof, lambda: run_tracker(ttr, views, mono=False))
    print(f"stereo spans: port {t}, JAX {j}")
    assert t == j
    assert t.get("frame_build", 0) + t.get("track_frame_fused", 0) == 6
    assert t["keyframe_insert"] == 5  # one per tracked frame
    # the viewers' frame: the last left image as it was passed, no copy
    assert ttr.last_image is views[-1][0]


def test_device_trace_writes_an_annotated_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with tprof.device_trace(d, cuda=False):
        with tprof.annotate("orb_stage_marker"):
            torch.ones(8).cumsum(0)
    path = os.path.join(d, tprof.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "orb_stage_marker" for e in events)
    assert any("cumsum" in str(e.get("name")) for e in events)
