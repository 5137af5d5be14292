"""The JAX package and the port frame by frame on the capped TUM mono run,
on the CPU, with every random draw of the port fed in from the JAX
package.

    python examples/mono_tum_lockstep.py [--data DIR] [--out FILE] [--device cuda]

Renders `tools/dataset_runs.FULL["tum-mono"]` (360 frames at 640x480, 5
blank frames from 300, `Tracker.maxFramesBetweenKF: 5`) into --data
unless it already holds a dataset, then runs the JAX `System` and the
port's `System(device="cpu")` on the same frames, both with the JAX
package's L5 vocabulary (the vocabulary of the recorded JAX figure). The
port draws what the JAX Tracker draws:

- the initialization's RANSAC hypotheses (`Tracker._ransac_samples`) and
  the relocalization's PnP hypotheses (`Tracker._pnp_sampler`) from one
  key chain, as the JAX Tracker splits `self.key` for each
  initialization attempt and each candidate that reaches PnP
  (`engine/relocalization.py:52`), then once per PnP round;
- the loop's Sim3 hypotheses (`LoopCloser.sim3_sampler`) from the
  closer's own chain (`engine/loop_closing.py:378`, :522).

A third System, the JAX package's twin, runs beside them with the same
draws; right after it initializes, its map points move by TWIN_NOISE of
their norm. It shows how fast the JAX package parts from itself from a
rounding-sized start, against which the port's parting is read.

Each frame prints the three packages' state, whether they inserted a
keyframe or closed a loop, the tracked points, the live map points, and
the largest entry of |Tcw - Tcw_jax| for the port and the twin. At the
end it prints the first frame where the states or counts differ or the
pose gap passes POSE_GAP, the gaps on a few frames, the ATEs
(Sim3-aligned), and each package's ATE with its own draws at the tracker
seeds SEEDS (WORKERS processes at once), beside a two-sided Mann-Whitney
test of the two samples: the spread that tells a fault from float32
chaos. The JSON of all of it goes to --out.

The port's operations are also fed, on the port's own inputs, to the
JAX package's, and the outputs compared (`Probes`), each against the
bound of its parity test (OP_BOUNDS): on frames 0-PROBE_FRAMES every
frame build, matching and tracking step, pose optimization, keyframe
insert, its triangulations and its local BA; on each relocalizing frame
`relocalize` from the same key; on each loop attempt
`LoopCloser._compute_and_correct` from the same key, with the scale free
as in every monocular run. The insert, its triangulations and its local
BA are ill-conditioned in float32, so the JAX package also runs them
with one camera moved BA_NUDGE (each live keyframe in turn for the local
BA): the port may part from the JAX package by that much of its own
spread (SPREAD_FACTOR; point counts and gate decisions by no more than
the moved run's).

It imports both packages, as the parity tests do; the port itself
imports no JAX. On an 8-core CPU the whole takes about 80 minutes (the
lockstep about 40, the seed runs three at once beside it).

With --device cuda it runs only the port's seed runs, one after the
other on the card, with the card's name and power limit (no JAX: the
card's machine has none); the port's spread there beside the CPU's. The
seeds run twice: with the card's BRIEF selection (one bf16 pass, as the
TPU runs the JAX package's), then with the CPU's float32 one, the ORB
angles and descriptors computed on the CPU from the card's patches.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

L5 = os.path.join(ROOT, "orb_slam2_test_tpu", "data", "vocab_k10_L5.npz")
# a frame parts when the largest entry of |Tcw_port - Tcw_jax| passes this
POSE_GAP = 1e-3
THREADS = 2
SEEDS = tuple(range(10))
WORKERS = 3
# the per-frame operations are compared on frames 0 to this one
PROBE_FRAMES = 40
# the twin's map points move by this share of their norm
TWIN_NOISE = 1e-6
# a camera moved this far (m) for the JAX package's own spread; an
# operation may part from it by SPREAD_FACTOR times that spread
BA_NUDGE = 1e-6
SPREAD_FACTOR = 2.0
# the operations' bounds, from their parity tests: largest pose entry
# apart, share of links (features or map slots) equal, counts within
# COUNT_RTOL (tests/test_torch_tracking.py, test_torch_pose_opt.py,
# test_torch_grow_map.py, test_torch_local_mapping.py,
# test_torch_relocalization.py, test_torch_loop_closing.py)
OP_BOUNDS = {"track": 1e-4, "local_map": 1e-4, "pose_opt": 1e-4, "local_ba": 1e-4,
             "insert": 1e-4, "insert_light": 2e-3, "relocalize": 1e-4, "loop": 1e-4}
LINKS_EQUAL = 0.99
COUNT_RTOL = 0.01
# triangulate_dlt: the port's largest distance from float64 within this
# many times the JAX package's (tests/test_torch_low_parallax.py)
F64_RATIO = 2.0
# a seed sample lies apart from the other at a two-sided p below this
DISTINCT_P = 0.01


def _setup(with_jax: bool = True) -> None:
    """Both packages (or the port alone) on the CPU, THREADS threads each."""

    torch.set_num_threads(THREADS)
    if with_jax:
        import jax

        jax.config.update("jax_platforms", "cpu")


def render(data: str) -> None:
    """The full-length TUM mono dataset into `data` (skipped if it is there)."""
    from orb_slam2_test_tpu_torch.tools import dataset_runs

    if os.path.exists(os.path.join(data, "rgb.txt")):
        return
    frames, at = dataset_runs.FULL["tum-mono"]
    t0 = time.perf_counter()
    dataset_runs.finish_dataset(dataset_runs.start_dataset("tum-mono", data, frames, at),
                                "tum-mono", data, timeout=1800)
    print(f"rendered {frames} frames into {data} in {time.perf_counter() - t0:.1f} s",
          flush=True)


class JaxDraws:
    """The JAX Tracker's key chain, as the port's draw hooks return it.

    `ransac(valid)` is one initialization attempt (a split, then the
    homography and fundamental keys as `initialize_mono` splits them);
    `pnp()` one relocalization candidate that reaches PnP (a split, then
    one split per PnP round, as `pnp_ransac_adaptive` draws)."""

    def __init__(self, seed: int):
        import jax

        self.key = jax.random.PRNGKey(seed)

    def ransac(self, valid):
        import jax
        import jax.numpy as jnp
        from orb_slam2_test_tpu.solvers import initializer as jinit

        self.key, sub = jax.random.split(self.key)
        v = jnp.array(valid.cpu().numpy())
        return tuple(torch.from_numpy(np.array(jinit._sample_indices(
            k, v, jinit.RANSAC_ITERS, jinit.SAMPLE))) for k in jax.random.split(sub))

    def pnp(self):
        import jax
        import jax.numpy as jnp

        self.key, sub = jax.random.split(self.key)
        chain = [sub]

        def draw(valid, n):
            chain[0], k = jax.random.split(chain[0])
            p = jnp.array(valid.cpu().numpy()).astype(jnp.float32)
            p = p / jnp.maximum(jnp.sum(p), 1.0)
            return torch.from_numpy(np.array(jax.random.choice(
                k, valid.shape[0], shape=(n, 6), replace=True, p=p)))
        return draw


class JaxSim3Draws:
    """The JAX LoopCloser's Sim3 draws: one split of its key per RANSAC."""

    def __init__(self, seed: int):
        import jax

        self.key = jax.random.PRNGKey(seed)

    def __call__(self, valid, n_iters):
        import jax
        import jax.numpy as jnp

        self.key, k = jax.random.split(self.key)
        p = jnp.array(valid.cpu().numpy()).astype(jnp.float32)
        p = p / jnp.maximum(jnp.sum(p), 1.0)
        return torch.from_numpy(np.array(jax.random.choice(
            k, valid.shape[0], shape=(n_iters, 3), replace=True, p=p)))


def make_jax(data: str, seed: int | None = None):
    from orb_slam2_test_tpu import system as jsys

    s = jsys.System(os.path.join(data, "settings.yaml"), jsys.MONOCULAR, vocabulary=L5)
    if seed is not None:
        import jax

        s.tracker.key = jax.random.PRNGKey(seed)
    return s


def make_port(data: str, seed: int | None = None, device: str = "cpu"):
    from orb_slam2_test_tpu_torch import system as tsys

    s = tsys.System(os.path.join(data, "settings.yaml"), tsys.MONOCULAR, vocabulary=L5,
                    device=device)
    if seed is not None:
        s.tracker.generator.manual_seed(seed)
    return s


def feed_jax_draws(port) -> tuple[JaxDraws, JaxSim3Draws]:
    """Point the port System's draw hooks at the JAX package's key
    chains (the Tracker's from its seed, the closer's from its default
    seed 7)."""
    tr = port.tracker
    draws, sim3 = JaxDraws(tr.cfg.seed), JaxSim3Draws(7)
    tr._ransac_samples = draws.ransac
    tr._pnp_sampler = draws.pnp
    tr.loop_closer.sim3_sampler = sim3
    return draws, sim3


def nudge_twin(twin) -> None:
    """Move the twin's map points by TWIN_NOISE of their norm (a numpy
    seed), once, right after it initializes."""
    import jax.numpy as jnp

    m = twin.tracker.map
    x = np.array(m.pt_xyz, np.float64)
    step = np.random.default_rng(0).normal(size=x.shape)
    x = x + TWIN_NOISE * np.linalg.norm(x, axis=-1, keepdims=True) * step
    twin.tracker.map = m._replace(pt_xyz=jnp.array(x, jnp.float32))


def _frame_row(system, before: dict, jax_map: bool) -> dict:
    """The frame's state, whether it made a keyframe or closed a loop
    (`before`: the tracker's stats before the frame), tracked and live
    map points, and the pose."""

    tr = system.tracker
    valid = tr.map.pt_valid
    return {"state": tr.state, "kf": tr.stats["n_kf"] > before["n_kf"],
            "loop": tr.stats["loops"] > before["loops"], "tracked": int(tr.n_tracked),
            "points": int(np.array(valid).sum()) if jax_map else int(valid.sum()),
            "Tcw": np.array(tr.last_Tcw, np.float64)}


def _ate(system, data: str, jax_side: bool) -> dict:
    if jax_side:
        from orb_slam2_test_tpu.evaluation import absolute_trajectory_error
        from orb_slam2_test_tpu.io.trajectory import load_trajectory_tum
    else:
        from orb_slam2_test_tpu_torch.evaluation import absolute_trajectory_error
        from orb_slam2_test_tpu_torch.io.trajectory import load_trajectory_tum
    res = absolute_trajectory_error(system.tracker.export_trajectory(),
                                    load_trajectory_tum(os.path.join(data, "groundtruth.txt")),
                                    with_scale=True)
    st = system.tracker.stats
    return {"ate_m": float(res["rmse"]), "pairs": int(res["n_pairs"]), "keyframes": st["n_kf"],
            "lost": st["lost_frames"], "relocs": st["reloc"], "loops": st["loops"]}


def _jax_map(m):
    import jax.numpy as jnp
    from orb_slam2_test_tpu.slam_map.mapstate import MapState
    from orb_slam2_test_tpu_torch import entry

    return MapState(**{k: jnp.array(v) for k, v in entry.map_to_numpy(m).items()})


def _jax_frame(frame):
    import jax.numpy as jnp
    from orb_slam2_test_tpu.engine.frame import FrameData

    f = [x.cpu().numpy() for x in frame]
    f[4] = f[4].view("uint32")  # the descriptors' int32 bit patterns
    return FrameData(*[jnp.array(x) for x in f])


def _j(x):
    """A port tensor as a JAX array (descriptors stay int32: callers
    view them as the JAX package's uint32); other values as they are."""
    import jax.numpy as jnp

    return jnp.array(x.cpu().numpy()) if torch.is_tensor(x) else x


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.array(x)


def _equal_share(a, b) -> float:
    """The share of entries equal among those that are a link (>= 0) in
    either."""
    a, b = _np(a), _np(b)
    linked = (a >= 0) | (b >= 0)
    return float((a == b)[linked].mean()) if linked.any() else 1.0


def _counts_close(pairs) -> bool:
    return all(abs(float(p) - float(j)) <= COUNT_RTOL * abs(float(j)) for p, j in pairs)


def _map_gaps(tm, jm) -> dict:
    """Two maps (as numpy dicts): the largest live keyframe pose entry
    apart, the share of links equal, and the points' relative distance
    (99th percentile and largest) where both are valid."""
    live, pv = tm["kf_valid"], tm["pt_valid"] & jm["pt_valid"]
    rel = (np.linalg.norm(tm["pt_xyz"][pv] - jm["pt_xyz"][pv], axis=-1)
           / np.maximum(np.linalg.norm(jm["pt_xyz"][pv], axis=-1), 1e-12))
    return {"gap": float(np.abs(tm["kf_Tcw"][live] - jm["kf_Tcw"][live]).max()),
            "links_equal": _equal_share(tm["kf_pt_idx"][live], jm["kf_pt_idx"][live]),
            "pt_valid_differ": int((tm["pt_valid"] != jm["pt_valid"]).sum()),
            "point_rel_p99": float(np.percentile(rel, 99)) if rel.size else 0.0,
            "point_rel_max": float(rel.max(initial=0.0))}


class Probes:
    """The port's operations on the lockstep run's port side, each also
    fed to the JAX package's counterpart on the same inputs, as a context
    manager: on entry the port's module functions (and the closer's
    `_compute_and_correct`) are rebound to wrappers that compare each
    call as it returns, and on exit every rebinding is undone.

    Each comparison appends to `ops` a row with the frame, the
    operation, its `gap` (largest pose entry apart) and `ok` (within
    its bound, or the JAX package's own spread where the comparison
    measures one); relocalize and the loop append to `relocs` and
    `loops`, from the key the port's draws were about to split."""

    def __init__(self, port, draws: JaxDraws, sim3: JaxSim3Draws, jax_voc):
        self.port, self.draws, self.sim3, self.jax_voc = port, draws, sim3, jax_voc
        self.ops, self.relocs, self.loops = [], [], []
        self.frame = -1
        self._saved = []
        self._jax = {}

    # -- rebinding

    def _rebind(self, owner, name: str, wrapper) -> None:
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, wrapper(orig))

    def _each(self, compare):
        """A wrapper that calls the port's function, then `compare` on
        frames 0-PROBE_FRAMES."""

        def wrap(orig):
            def call(*args, **kw):
                out = orig(*args, **kw)
                if self.frame <= PROBE_FRAMES:
                    self.ops.append({"frame": self.frame, **compare(orig, args, kw, out)})
                return out
            return call
        return wrap

    def __enter__(self):
        from orb_slam2_test_tpu_torch.engine import local_mapping, tracking

        for name, compare in (("build_frame_mono", self._build), ("_pose_opt_on", self._pose),
                              ("match_by_descriptor_to_map", self._match),
                              ("_build_and_track_device", self._track),
                              ("_local_map_step_device", self._local_map),
                              ("run_local_ba", self._local_ba),
                              ("_grow_map_device", self._insert)):
            self._rebind(tracking, name, self._each(compare))
        self._rebind(local_mapping, "triangulate_dlt", self._wrap_triangulate)
        self._rebind(local_mapping, "triangulation_checks", self._wrap_checks)
        self._rebind(tracking, "relocalize", self._wrap_reloc)
        self._rebind(self.port.tracker.loop_closer, "_compute_and_correct", self._wrap_loop)
        return self

    def __exit__(self, *exc) -> None:
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved.clear()

    def next_frame(self, i: int) -> None:
        self.frame = i

    # -- the JAX package's side

    def _jcam(self, cam):
        from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JCam

        return JCam(**cam._asdict())

    def _jcfg(self, cfg):
        from orb_slam2_test_tpu.engine import tracking as jtracking

        return jtracking.TrackerConfig(**dataclasses.asdict(cfg))

    def _jit(self, name: str):
        """The JAX package's functions compiled as inside its programs."""
        import jax

        if name not in self._jax:
            from orb_slam2_test_tpu.engine import frame as jframe
            from orb_slam2_test_tpu.engine import local_mapping as jlm
            from orb_slam2_test_tpu.engine import matchers as jmatch
            from orb_slam2_test_tpu.engine import tracking as jtracking
            from orb_slam2_test_tpu.geometry import triangulation as jtri

            self._jax.update({
                "build": jax.jit(jframe.build_frame_mono, static_argnums=(2,),
                                 static_argnames=("n_features", "n_levels", "scale_factor")),
                "pose": jax.jit(jtracking._pose_opt_on, static_argnums=(0, 1)),
                "match": jax.jit(jmatch.match_by_descriptor_to_map),
                "track": jtracking._track_frame_device,
                "local_map": jtracking._local_map_step_device,
                "local_ba": jax.jit(jlm.run_local_ba, static_argnums=(1, 3, 4)),
                "triangulate": jax.jit(jtri.triangulate_dlt)})
        return self._jax[name]

    # -- the comparisons, one per operation

    def _build(self, orig, args, kw, out):
        img, ts, cam = args
        j = self._jit("build")(_j(img), _j(ts), self._jcam(cam), **kw)
        tv, jv = out.valid.numpy(), np.array(j.valid)
        same = ((np.abs(out.uv.numpy() - np.array(j.uv)) <= 1e-3).all(-1)
                & (out.level.numpy() == np.array(j.level)) & (tv == jv))
        both = tv & jv
        desc = (out.desc.numpy().view(np.uint32) == np.array(j.desc)).all(-1)
        return {"op": "build_frame", "n_valid": [int(tv.sum()), int(jv.sum())],
                "keypoints_equal": float(same.mean()),
                "desc_equal": float(desc[both].mean()) if both.any() else 1.0,
                "ok": bool(same.all())}

    def _pose(self, orig, args, kw, out):
        cam, cfg, m, frame, feat_pt, Tcw0 = args
        j = self._jit("pose")(self._jcam(cam), self._jcfg(cfg), _jax_map(m), _jax_frame(frame),
                              _j(feat_pt), _j(Tcw0))
        gap = float(np.abs(out.Tcw.numpy() - np.array(j.Tcw)).max())
        inl = float((out.inliers.numpy() == np.array(j.inliers)).mean())
        counts = [int(out.n_inliers), int(j.n_inliers)]
        return {"op": "pose_opt", "gap": gap, "n_inliers": counts, "inliers_equal": inl,
                "ok": gap <= OP_BOUNDS["pose_opt"] and inl >= LINKS_EQUAL
                and _counts_close([counts])}

    def _match(self, orig, args, kw, out):
        frame, desc, valid, ids = args
        jd = _j(desc).view(np.uint32) if desc.dtype == torch.int32 else _j(desc)
        j = self._jit("match")(_jax_frame(frame), jd, _j(valid), _j(ids), **kw)
        eq = _equal_share(out.feat_pt, j.feat_pt)
        counts = [int(out.n_matches), int(j.n_matches)]
        return {"op": "match_to_map", "n_matches": counts, "links_equal": eq,
                "ok": eq >= LINKS_EQUAL and _counts_close([counts])}

    def _track(self, orig, args, kw, out):
        """The JAX package's tracking step on the port's frame and inputs."""
        (cam, cfg, sensor, m, bm, _, _, _, vel, T_cr, last_feat, last_frame, ref_kf,
         close_depth) = args
        import jax.numpy as jnp

        frame, t = out
        j = self._jit("track")(self._jcam(cam), self._jcfg(cfg), _jax_map(m), _j(bm),
                               _jax_frame(frame), _j(vel), _j(T_cr), _j(last_feat),
                               _jax_frame(last_frame), _j(ref_kf),
                               jnp.float32(float(close_depth)))
        gap = max(float(np.abs(_np(t[i]) - np.array(j[i])).max()) for i in (2, 5, 9))
        links = min(_equal_share(t[i], j[i]) for i in (7, 13))
        counts = [[int(t[i]), int(j[i])] for i in (0, 1, 6, 14)]
        ok = (gap <= OP_BOUNDS["track"] and links >= LINKS_EQUAL and _counts_close(counts)
              and int(t[4]) == int(j[4]))
        return {"op": "track", "gap": gap, "links_equal": links,
                "counts": counts, "ok": ok}

    def _local_map(self, orig, args, kw, out):
        cam, cfg, m, bm, frame, Tcw, cur_feat, ref_kf = args
        j = self._jit("local_map")(self._jcam(cam), self._jcfg(cfg), _jax_map(m), _j(bm),
                                   _jax_frame(frame), _j(Tcw), _j(cur_feat), _j(ref_kf))
        gap = max(float(np.abs(_np(out[i]) - np.array(j[i])).max()) for i in (2, 6))
        links = _equal_share(out[4], j[4])
        counts = [[int(out[3]), int(j[3])]]
        return {"op": "local_map", "gap": gap, "links_equal": links, "counts": counts,
                "ok": gap <= OP_BOUNDS["local_map"] and links >= LINKS_EQUAL
                and _counts_close(counts) and int(out[1]) == int(j[1])}

    def _local_ba(self, orig, args, kw, out):
        """The JAX package's local BA on the port's inputs, and again
        with each live keyframe's start moved BA_NUDGE along x in turn:
        the gap is held to the bound or to SPREAD_FACTOR times the
        largest of those moves (the reference's own spread)."""
        from orb_slam2_test_tpu.engine.local_mapping import LocalBACaps
        from orb_slam2_test_tpu.slam_map.mapstate import MapCapacity
        from orb_slam2_test_tpu_torch import entry

        m, cam, kf, cap, caps = args
        jm = _jax_map(m)
        statics = (self._jcam(cam), MapCapacity(**dataclasses.asdict(cap)),
                   LocalBACaps(**dataclasses.asdict(caps)))
        jkw = {k: _j(v) for k, v in kw.items()}

        def solve(mm):
            r = self._jit("local_ba")(mm, statics[0], _j(kf), *statics[1:], **jkw)
            return {k: np.array(v) for k, v in r._asdict().items()}

        j = solve(jm)
        row = _map_gaps(entry.map_to_numpy(out), j)
        row["jax_spread"] = max(
            _map_gaps(solve(jm._replace(kf_Tcw=jm.kf_Tcw.at[k, 0, 3].add(BA_NUDGE))), j)["gap"]
            for k in np.flatnonzero(j["kf_valid"]))
        return {"op": "local_ba", **row,
                "ok": row["gap"] <= max(OP_BOUNDS["local_ba"], SPREAD_FACTOR * row["jax_spread"])
                and row["links_equal"] >= LINKS_EQUAL}

    def _insert(self, orig, args, kw, out):
        """The JAX package's insert on the port's inputs, and again with
        the new keyframe's pose moved BA_NUDGE along x (its own spread):
        the port's point count may differ from the JAX package's by no
        more than the nudged one's does, and its poses by the bound or
        SPREAD_FACTOR times the nudged one's gap."""
        import jax.numpy as jnp
        from orb_slam2_test_tpu.engine import tracking as jtracking
        from orb_slam2_test_tpu_torch import entry

        cam, cfg, m, bm, frame, Tcw, feat, ts, fid, cd, use_depth, gate = args
        rest = (_j(feat), jnp.float32(ts), jnp.int32(fid), jnp.float32(cd), use_depth, gate)
        head = (self._jcam(cam), self._jcfg(cfg), _jax_map(m), _j(bm), _jax_frame(frame))
        jT = _j(Tcw)
        jo = jtracking._grow_map_device(*head, jT, *rest, **kw)
        jn = jtracking._grow_map_device(*head, jT.at[0, 3].add(BA_NUDGE), *rest, **kw)
        jm = {k: np.array(v) for k, v in jo[0]._asdict().items()}
        rebuild = kw.get("rebuild", True)
        row = _map_gaps(entry.map_to_numpy(out[0]), jm)
        row["jax_spread"] = _map_gaps({k: np.array(v) for k, v in jn[0]._asdict().items()},
                                      jm)["gap"]
        counts = [int(out[3]), int(jo[3]), int(jn[3])]
        bound = OP_BOUNDS["insert" if rebuild else "insert_light"]
        return {"op": "insert", "rebuild": rebuild, "n_pt": counts, **row,
                "ok": abs(counts[0] - counts[1]) <= abs(counts[2] - counts[1])
                and row["links_equal"] >= LINKS_EQUAL
                and row["gap"] <= max(bound, SPREAD_FACTOR * row["jax_spread"])}

    def _wrap_triangulate(self, orig):
        """triangulate_dlt, kept until the triangulation_checks call on
        its points."""

        def call(*args):
            out = orig(*args)
            if self.frame <= PROBE_FRAMES:
                self._triangulated = (orig, args, out)
            return out
        return call

    def _wrap_checks(self, orig):
        """triangulation_checks; on the points of the triangulation just
        made, it compares that triangulation."""

        def call(cam, T1, T2, x, *args, **kw):
            made, self._triangulated = getattr(self, "_triangulated", None), None
            if made is not None:
                self._triangulate(*made, lambda pts: orig(cam, T1, T2, pts, *args, **kw))
            return orig(cam, T1, T2, x, *args, **kw)
        return call

    def _triangulate(self, orig, args, out, gates) -> None:
        """The JAX package's (compiled) DLT on the same rows, again with
        the second camera's centre moved BA_NUDGE along x (its own
        spread), and the float64 DLT; the gates (cheirality, parallax,
        reprojection) on each solution, the float64 one rounded to
        float32. The port's gates may differ from the JAX package's on
        no more points than the nudged JAX package's do, and its
        largest distance from float64 may be F64_RATIO times the larger
        of the two JAX solutions'."""
        P1, P2, uv1, uv2 = (_j(a) for a in args)
        jtd = self._jit("triangulate")
        j = torch.from_numpy(np.array(jtd(P1, P2, uv1, uv2)))
        jn = torch.from_numpy(np.array(jtd(P1, P2.at[..., 3].add(-BA_NUDGE * P2[..., 0]),
                                           uv1, uv2)))
        x64 = orig(*(a.double() for a in args))
        ok = {k: gates(torch.where(torch.isfinite(x), x, 0.0)).ok.numpy()
              for k, x in (("port", out), ("jax", j), ("jax_nudged", jn), ("f64", x64.float()))}
        acc = ok["port"] | ok["jax"] | ok["jax_nudged"]
        rel = {k: (np.linalg.norm((x.double() - x64).numpy()[acc], axis=-1)
                   / np.linalg.norm(x64.numpy()[acc], axis=-1)).max(initial=0.0)
               for k, x in (("port", out), ("jax", j), ("jax_nudged", jn))}
        row = {"frame": self.frame, "op": "triangulate_dlt",
               "accepted": [int(ok[k].sum()) for k in ("port", "jax", "jax_nudged", "f64")],
               "gates_differ": int((ok["port"] != ok["jax"]).sum()),
               "jax_spread_gates": int((ok["jax_nudged"] != ok["jax"]).sum()),
               **{f"{k}_vs_f64_rel_max": float(v) for k, v in rel.items()}}
        row["ok"] = bool(row["gates_differ"] <= row["jax_spread_gates"]
                         and rel["port"] <= F64_RATIO * max(rel["jax"], rel["jax_nudged"]))
        self.ops.append(row)

    def _wrap_reloc(self, orig):
        def call(frame, m, cam, cands, sampler, sig2, **kw):
            key = self.draws.key
            out = orig(frame, m, cam, cands, sampler, sig2, **kw)
            self.relocs.append(self._compare_reloc(orig, frame, m, cam, cands, sig2, key, kw,
                                                   out))
            return out
        return call

    def _wrap_loop(self, orig):
        def call(m, kf_id, cand):
            key = self.sim3.key
            out = orig(m, kf_id, cand)
            self.loops.append(self._compare_loop(m, kf_id, cand, key, out))
            return out
        return call

    def _compare_reloc(self, orig, frame, m, cam, cands, sig2, key, kw, out) -> dict:
        """The JAX package's relocalize from the same key; and the port's
        again from that key with the JAX package's `_extract_rt`, which
        turns R by 180 degrees where the DLT's det P < 0 (a JAX fault the
        port departs from, ROADMAP queue 3): what is left between the
        two once that is shared."""
        import jax.numpy as jnp
        from orb_slam2_test_tpu.engine.relocalization import relocalize as jrelocalize
        from orb_slam2_test_tpu.solvers import pnp as jpnp
        from orb_slam2_test_tpu_torch.solvers import pnp as tpnp

        ok, Tcw, feat_pt, info = out
        jok, jT, jfp, _ = jrelocalize(_jax_frame(frame), _jax_map(m), self._jcam(cam),
                                      list(cands), key, sig2.cpu().numpy(), **kw)
        row = {"frame": self.frame, "candidates": len(cands), "ok": [bool(ok), bool(jok)],
               **info}
        if not (ok and jok):
            return row
        row["pose_gap"] = float(np.abs(np.array(Tcw) - np.array(jT)).max())
        row["links_equal"] = float((feat_pt.cpu().numpy() == np.array(jfp)).mean())

        def jax_extract_rt(P):
            return tuple(torch.from_numpy(np.array(x))
                         for x in jpnp._extract_rt(jnp.array(P.cpu().numpy())))

        draws = JaxDraws(0)
        draws.key = key
        saved, tpnp._extract_rt = tpnp._extract_rt, jax_extract_rt
        try:
            ok2, T2, fp2, _ = orig(frame, m, cam, cands, draws.pnp, sig2, **kw)
        finally:
            tpnp._extract_rt = saved
        row["ok_jax_extract_rt"] = bool(ok2)
        if ok2:
            row["pose_gap_jax_extract_rt"] = float(np.abs(np.array(T2) - np.array(jT)).max())
            row["links_equal_jax_extract_rt"] = float((fp2.cpu().numpy() == np.array(jfp)).mean())
        return row

    def _compare_loop(self, m, kf_id, cand, key, out) -> dict:
        from orb_slam2_test_tpu.engine.loop_closing import LoopCloser as JLoopCloser
        from orb_slam2_test_tpu_torch import entry

        closer = self.port.tracker.loop_closer
        jc = JLoopCloser(self._jcam(closer.cam), self.jax_voc, fix_scale=closer.fix_scale)
        jc.key = key
        jok, jm = jc._compute_and_correct(_jax_map(m), int(kf_id), int(cand))
        ok, tm = out
        row = {"frame": self.frame, "kf": int(kf_id), "candidate": int(cand),
               "fix_scale": closer.fix_scale, "closed": [bool(ok), bool(jok)]}
        if ok and jok:
            tm, jm = entry.map_to_numpy(tm), {k: np.array(v) for k, v in jm._asdict().items()}
            live, pv = tm["kf_valid"], tm["pt_valid"] & jm["pt_valid"]
            row["pose_gap"] = float(np.abs(tm["kf_Tcw"][live] - jm["kf_Tcw"][live]).max())
            row["links_equal"] = float((tm["kf_pt_idx"][live] == jm["kf_pt_idx"][live]).mean())
            row["point_gap_p99"] = float(np.percentile(
                np.abs(tm["pt_xyz"][pv] - jm["pt_xyz"][pv]).max(-1), 99))
        return row


# the frames whose gaps the report prints
GAP_FRAMES = (1, 2, 3, 4, 5, 6, 10, 20, 40, 100, 200, 299, 305, 359)


def _parted(a: dict, b: dict) -> tuple[bool, float]:
    """(whether two frame rows part, their pose gap); the rows lose their
    poses."""
    gap = float(np.abs(a.pop("Tcw") - b["Tcw"]).max())
    return a != {k: v for k, v in b.items() if k != "Tcw"} or gap > POSE_GAP, gap


def lockstep(data: str, log=print) -> dict:
    """The JAX package, its twin and the port frame by frame, the port
    fed the JAX draws, its operations held to the JAX package's on the
    way (`Probes`)."""
    from orb_slam2_test_tpu.engine.tracking import TrackingState
    from orb_slam2_test_tpu_torch.io.datasets import load_tum_mono

    seq = load_tum_mono(data)
    j, twin, p = make_jax(data), make_jax(data), make_port(data)
    rows, first, first_twin, nudged = [], None, None, False
    with Probes(p, *feed_jax_draws(p), j.vocabulary) as probes:
        for i, item in enumerate(seq.items):
            ts, img = seq.load(item)
            jb, wb, pb = (dict(s.tracker.stats) for s in (j, twin, p))
            probes.next_frame(i)
            for s in (j, twin, p):
                s.track_monocular(img, ts)
            if not nudged and twin.tracker.state == TrackingState.OK:
                nudge_twin(twin)
                nudged = True
            jr = _frame_row(j, jb, True)
            wr, pr = _frame_row(twin, wb, True), _frame_row(p, pb, False)
            parted, gap = _parted(pr, jr)
            twin_parted, twin_gap = _parted(wr, jr)
            jr.pop("Tcw")
            if parted and first is None:
                first = i
            if twin_parted and first_twin is None:
                first_twin = i
            rows.append({"frame": i, "jax": jr, "port": pr, "twin": wr, "gap": gap,
                         "twin_gap": twin_gap})
            log(f"{i:3d} {'*' if parted else ' '}{'t' if twin_parted else ' '} JAX "
                f"{jr['state']:>14s} kf {int(jr['kf'])} loop {int(jr['loop'])} tracked "
                f"{jr['tracked']:4d} points {jr['points']:5d} | port {pr['state']:>14s} kf "
                f"{int(pr['kf'])} loop {int(pr['loop'])} tracked {pr['tracked']:4d} points "
                f"{pr['points']:5d} gap {gap:.3e} | twin kf {int(wr['kf'])} tracked "
                f"{wr['tracked']:4d} points {wr['points']:5d} gap {twin_gap:.3e}", flush=True)
    return {"rows": rows, "first_parting": first, "first_twin_parting": first_twin,
            "ops": probes.ops, "relocalize": probes.relocs,
            "compute_and_correct": probes.loops, "jax": _ate(j, data, True),
            "twin": _ate(twin, data, True), "port_fed": _ate(p, data, False)}


def own_run(job: tuple) -> dict:
    """One package alone with its own draws at a tracker seed."""
    data, side, seed, device = job
    _setup(side == "jax")
    from orb_slam2_test_tpu_torch.io.datasets import load_tum_mono

    seq = load_tum_mono(data)
    s = make_jax(data, seed) if side == "jax" else make_port(data, seed, device)
    t0 = time.perf_counter()
    for item in seq.items:
        ts, img = seq.load(item)
        s.track_monocular(img, ts)
    out = _ate(s, data, side == "jax")
    out.update(side=side, seed=seed, wall_s=time.perf_counter() - t0)
    return out


def seed_spread(runs: list) -> dict:
    """Each side's ATE over its seeds (median, least, largest), and the
    two-sided Mann-Whitney p of each pair of sides (`p`; with both
    packages, the port's against the JAX package's also as
    `mannwhitney_p`, and whether it is below DISTINCT_P)."""
    from scipy.stats import mannwhitneyu

    ate = {}
    for r in runs:
        ate.setdefault(r["side"], []).append(r["ate_m"])
    out = {side: {"median": float(np.median(a)), "min": float(min(a)), "max": float(max(a)),
                  "n": len(a)} for side, a in ate.items()}
    sides = list(ate)
    out["p"] = {f"{a} / {b}": float(mannwhitneyu(ate[a], ate[b]).pvalue)
                for i, a in enumerate(sides) for b in sides[i + 1:]}
    if {"jax", "port"} <= ate.keys():
        out["mannwhitney_p"] = float(mannwhitneyu(ate["port"], ate["jax"]).pvalue)
        out["distinct"] = out["mannwhitney_p"] < DISTINCT_P
    return out


def _print_seeds(runs: list, where: str) -> None:
    for r in runs:
        print(f"{r['side']} seed {r['seed']} ({where}): ATE {r['ate_m']:.4f} m over "
              f"{r['pairs']} pairs, {r['keyframes']} keyframes, {r['lost']} lost, "
              f"{r['relocs']} relocs, {r['loops']} loops ({r['wall_s']:.0f} s)")
    spread = seed_spread(runs)
    for side in ("jax", "port", "port, float32 selection"):
        if side in spread:
            s = spread[side]
            print(f"{side} ({where}), {s['n']} seeds: ATE median {s['median']:.4f} m, "
                  f"{s['min']:.4f}-{s['max']:.4f} m")
    for pair, p in spread["p"].items():
        print(f"{pair} ({where}), two-sided Mann-Whitney: p = {p:.4g} "
              f"({'apart' if p < DISTINCT_P else 'not apart'} at {DISTINCT_P})")


def report(res: dict) -> None:
    rows = res["rows"]
    for name, key in (("port", "first_parting"), ("twin", "first_twin_parting")):
        f = res[key]
        print(f"first frame the {name} parts from the JAX package: "
              f"{'none' if f is None else f}")
    print("pose gap to the JAX package by frame (port / twin): " + ", ".join(
        f"{i}: {rows[i]['gap']:.2e} / {rows[i]['twin_gap']:.2e}"
        for i in GAP_FRAMES if i < len(rows)))
    by_op = {}
    for r in res["ops"]:
        by_op.setdefault(r["op"], []).append(r)
    for op, rs in by_op.items():
        gaps = [r["gap"] for r in rs if "gap" in r]
        worst = f", largest gap {max(gaps):.3e}" if gaps else ""
        print(f"{op} on frames 0-{PROBE_FRAMES}, on the port's inputs: {len(rs)} calls"
              f"{worst}, {sum(not r['ok'] for r in rs)} outside the bound")
        for r in [r for r in rs if not r["ok"]][:10]:
            print(f"  outside: {r}")
    for r in res["relocalize"]:
        print(f"relocalize on the port's inputs (port, JAX): {r}")
    for r in res["compute_and_correct"]:
        if r["closed"] != [False, False]:
            print(f"_compute_and_correct on the port's inputs (port, JAX): {r}")
    print(f"_compute_and_correct: {len(res['compute_and_correct'])} attempts")
    for name in ("jax", "twin", "port_fed"):
        r = res[name]
        print(f"{name}: ATE {r['ate_m']:.4f} m over {r['pairs']} pairs, {r['keyframes']} "
              f"keyframes, {r['lost']} lost, {r['relocs']} relocs, {r['loops']} loops")
    _print_seeds(res["seeds"], "CPU")


def _dump(res: dict, path: str | None) -> None:
    if path:
        with open(path, "w") as f:
            json.dump(res, f, indent=1, default=lambda o: o.item() if hasattr(o, "item")
                      else str(o))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", default=None, help="dataset directory (default: a temporary one)")
    p.add_argument("--out", default=None, help="write the results as JSON here")
    p.add_argument("--device", default="cpu",
                   help="cuda: only the port's seed runs, on the card")
    args = p.parse_args(argv)
    if args.device != "cpu":
        return card_seeds(args)
    _setup()
    with tempfile.TemporaryDirectory() as tmp:
        data = args.data or os.path.join(tmp, "tum-mono")
        render(data)
        jobs = [(data, side, s, "cpu") for side in ("jax", "port") for s in SEEDS]
        with ProcessPoolExecutor(max_workers=WORKERS,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            futures = [pool.submit(own_run, job) for job in jobs]
            t0 = time.perf_counter()
            res = lockstep(data)
            res["lockstep_s"] = time.perf_counter() - t0
            res["seeds"] = [f.result() for f in futures]
    res["seed_spread"] = seed_spread(res["seeds"])
    report(res)
    _dump(res, args.out)
    return 0


def _cpu_orb(orig):
    """`extractor.orb_from_patches` on a CPU copy of the card's patches:
    the CPU's float32 BRIEF selection in place of the card's bf16 one."""

    def call(raw):
        angle, desc = orig(raw.cpu())
        return angle.to(raw.device), desc.to(raw.device)
    return call


def card_seeds(args) -> int:
    """The port's seed runs on the card, one after the other: with the
    card's BRIEF selection, then with the CPU's."""
    import subprocess

    from orb_slam2_test_tpu_torch.ops import extractor

    if not torch.cuda.is_available():
        print("mono_tum_lockstep: --device cuda needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        data = args.data or os.path.join(tmp, "tum-mono")
        render(data)
        runs = [own_run((data, "port", s, args.device)) for s in SEEDS]
        orig = extractor.orb_from_patches
        extractor.orb_from_patches = _cpu_orb(orig)
        try:
            for s in SEEDS:
                runs.append({**own_run((data, "port", s, args.device)),
                             "side": "port, float32 selection"})
        finally:
            extractor.orb_from_patches = orig
    _print_seeds(runs, card)
    _dump({"device": card, "seeds": runs, "seed_spread": seed_spread(runs)}, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
