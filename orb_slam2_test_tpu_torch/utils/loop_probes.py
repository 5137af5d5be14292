"""Instruments for runs that close loops: the loop closer's stages on
CUDA events, the tracked trajectory against any map's keyframe poses,
its ATE, and the correction with its loop connections left out.

chip_smoke.py and examples/kitti_loop_run.py time and judge their loop
runs with these; nothing of the engine imports them.
"""

from __future__ import annotations

import contextlib
import statistics

import numpy as np
import torch


def ate(traj, T_true) -> dict:
    """ATE of an exported trajectory [(t, Tcw)] against exact Tcw poses,
    matched by index (the timestamps are the frames')."""
    from orb_slam2_test_tpu_torch.evaluation import absolute_trajectory_error

    gt = [(t, np.linalg.inv(T)) for (t, _), T in zip(traj, T_true)]
    return absolute_trajectory_error(traj, gt)


def trajectory_on(rel_trajectory, m) -> list:
    """A Tracker's `rel_trajectory` [(t, ref, T_cr)] against the keyframe
    poses of m (anything with kf_Tcw, kf_valid, kf_parent and kf_Tcp, as
    tensors or arrays), as `Tracker.export_trajectory` computes it,
    without draining the backend."""
    from orb_slam2_test_tpu_torch.engine.tracking import Tracker

    kf_Tcw, kf_valid, kf_parent, kf_Tcp = (
        x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        for x in (m.kf_Tcw, m.kf_valid, m.kf_parent, m.kf_Tcp))
    return [(ts, T_cr @ Tracker._resolve_ref_pose(int(ref), kf_Tcw, kf_valid, kf_parent, kf_Tcp))
            for ts, ref, T_cr in rel_trajectory]


@contextlib.contextmanager
def loop_connections_left_out(module):
    """`module._correct_loop_device` (a loop-closing module of either
    package) with its full covisibility matrix taken from the map it was
    given, the links before SearchAndFuse, so the fuse's new links make
    no covisibility edge of the essential graph. One correction per
    context; a jitted program must be traced again inside and after (the
    caller clears its caches)."""
    orig = module.covisibility_weights
    given = []

    def weights(m, query_kf=None):
        if query_kf is not None:  # the first call sees the map as given
            if not given:
                given.append(m)
            return orig(m, query_kf)
        return orig(given[0])

    module.covisibility_weights = weights
    try:
        yield
    finally:
        module.covisibility_weights = orig


class LoopTimes:
    """CUDA-event ms of each call of the loop closer's stages: detection
    (on_new_keyframe minus the Sim3 and correction), ComputeSim3
    (_compute_and_correct minus the correction), the correction program,
    each global BA chunk and the apply. With `sync` every wrapper waits
    for its end event, so the stages are timed one by one; without it the
    events are read once the run is over (`ms` waits for the card), so
    the instrument adds no host sync to the frames it times."""

    STAGES = ("on_new_keyframe", "compute_and_correct", "correct_loop_device", "gba_chunk",
              "apply_gba")

    def __init__(self, closer, lc_module, sync: bool = True):
        self.sync = sync
        self._events = {k: [] for k in self.STAGES}
        # (kf, on_new_keyframe, compute_and_correct, correct) event indices per loop
        self._flush = []
        # the keyframe capacity K of each correction's map and each chunk's problem
        self.K = {"correct_loop_device": [], "gba_chunk": []}
        self.captured = None  # the first correction's inputs
        self.on_capture = None
        self._restore = []
        lc = lc_module
        self._wrap(lc, "_correct_loop_device", "correct_loop_device", capture=True)
        self._wrap(lc, "_apply_gba_device", "apply_gba")
        self._wrap(closer, "_compute_and_correct", "compute_and_correct")
        self._wrap(closer, "on_new_keyframe", "on_new_keyframe")
        chunk = closer.advance_global_ba

        def advance(m):
            if not closer.gba_running():
                return chunk(m)
            self.K["gba_chunk"].append(closer._gba["prob"].cam_Tcw.shape[0])
            return self._timed(chunk, "gba_chunk", m)

        closer.advance_global_ba = advance
        self._restore.append((closer, "advance_global_ba", None))
        self.closer = closer

    @property
    def ms(self) -> dict:
        """{stage: [ms of each call]}."""
        if not self.sync:
            torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e in v] for k, v in self._events.items()}

    @property
    def loop_flush(self) -> list:
        """[(kf, on_new_keyframe ms, compute_and_correct ms, correct ms)]
        of each keyframe that closed a loop."""
        ms = self.ms
        return [(kf, ms["on_new_keyframe"][a], ms["compute_and_correct"][b],
                 ms["correct_loop_device"][c]) for kf, a, b, c in self._flush]

    def _timed(self, fn, name, *a, **k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a, **k)
        end.record()
        if self.sync:
            end.synchronize()
        self._events[name].append((start, end))
        return out

    def _wrap(self, obj, attr, name, capture=False):
        fn = getattr(obj, attr)

        def timed(*a, **k):
            if name in self.K:
                self.K[name].append(a[1].kf_valid.shape[0])
            if capture and self.captured is None:
                m, kf_id, cand, S12, fix = a[1:6]
                self.captured = ([x.clone() for x in m], kf_id.clone(), cand.clone(),
                                 S12.clone(), fix)
                if self.on_capture is not None:
                    self.on_capture(m)
            out = self._timed(fn, name, *a, **k)
            if name == "on_new_keyframe" and out[1]:
                self._flush.append((a[1], *(len(self._events[s]) - 1 for s in (
                    "on_new_keyframe", "compute_and_correct", "correct_loop_device"))))
            return out

        setattr(obj, attr, timed)
        self._restore.append((obj, attr, fn))

    def restore(self):
        for obj, attr, fn in self._restore:
            if fn is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, fn)

    def report(self, tag: str, card: str) -> dict:
        ms = self.ms
        for kf, onk, cc, corr in self.loop_flush:
            print(f"{tag} loop at keyframe {kf}: its flush {onk:.1f} ms on CUDA events "
                  f"(detection {onk - cc:.1f}, ComputeSim3 {cc - corr:.1f} with the global "
                  f"BA's start, _correct_loop_device {corr:.1f}; {card})")
        print(f"{tag} global BA chunks: " + ", ".join(f"{x:.1f}" for x in ms["gba_chunk"])
              + f" ms; the apply {', '.join(f'{x:.1f}' for x in ms['apply_gba'])} ms "
              f"(inside the last chunk; CUDA events)")
        return {"loop_flush_ms": [{"kf": kf, "flush": onk, "detection": onk - cc,
                                   "compute_sim3": cc - corr, "correct_loop_device": corr}
                                  for kf, onk, cc, corr in self.loop_flush],
                "gba_chunk_ms": ms["gba_chunk"], "apply_gba_ms": ms["apply_gba"],
                "on_new_keyframe_median_ms": (statistics.median(ms["on_new_keyframe"])
                                              if ms["on_new_keyframe"] else None)}
