"""Where the card misses a loop the CPU closes, on the capped TUM mono run.

    python3 examples/loop_miss_probe.py --out DIR [--data DIR]   (on the card; no JAX)
    JAX_PLATFORMS=cpu python examples/loop_miss_probe.py --spread DIR [--data DIR]
                                                     (on the CPU, both packages)
    JAX_PLATFORMS=cpu python examples/loop_miss_probe.py --cpu-runs [--out DIR] [--data DIR]
                                                     (on the CPU, both packages)

On the card: renders `tools/dataset_runs.FULL["tum-mono"]` (as
examples/mono_tum_lockstep.py does) unless --data holds it, runs the
port's System on the card at tracker seed SEED up to the first frame
after AFTER that inserts a keyframe, copies the card Tracker's state to
the CPU there (`entry.tracker_to`), and runs both on over the remaining
frames. Every keyframe either loop closer sees is recorded by device: the
database query's scored candidates and its minimum score, the candidate
the consistency chain returns, and for a candidate each ComputeSim3
stage (SearchByBoW's matches, the Sim3 RANSAC's success and inliers,
SearchBySim3's matches, optimize_sim3's inliers, the final gate's total
support) and whether the loop closed. It prints the first step whose
decision differs between the devices and writes DIR/loop_probe.json, and
the card's inputs of its first SAVES ComputeSim3 calls after the copy
that reach the Sim3 RANSAC (the map, the two keyframes, the RANSAC
draws; ~3 MB each) as DIR/compute_card_<kf>_<cand>.npz.

With --spread, on the CPU: for each card input in DIR, the port's
ComputeSim3 on the CPU with the card's draws, and the JAX package's with
the same draws, unmoved and with the map's points and keyframe positions
moved SPREAD_STEP m along seeded directions (SPREAD_MOVES times): each
stage's number beside its threshold, for the card, the CPU port and the
JAX package's spread at the call; written to DIR/loop_spread.json.

With --cpu-runs, on the CPU: the JAX System at SEED, its twin (map
points moved 1e-6 of their norm once it initializes, as
examples/mono_tum_lockstep.py's twin) and the port's own System at SEED,
in three processes: the loops, the ATE and each ComputeSim3 attempt's
stages of each; DIR/cpu_runs.json with --out.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))

SEED = 13  # the tracker seed at which the card misses the loop the CPU port closes
AFTER = 305  # the copy: the first keyframe after the blank frames 300-304
SAVES = 5  # the card's ComputeSim3 inputs saved: keyframes 66-70 against their candidates
SPREAD_MOVES = 16
SPREAD_STEP = 1e-6
# ComputeSim3's gates (engine/loop_closing.py, both packages)
GATES = {"pairs": 20, "ransac_inliers": 20, "optimize_inliers": 20, "total": 40}
STAGES = ("bow_matches", "pairs", "ransac_success", "ransac_inliers", "sim3_matches",
          "optimize_inliers", "total", "closed")


class StageLog:
    """ComputeSim3's stages, recorded through wrappers of a loop-closing
    module's functions into the event `current` (the keyframe a closer is
    on; one closer runs at a time): works for the port's module and the
    JAX package's."""

    def __init__(self, module):
        self.module = module
        self.current: dict = {}
        self.saved = {}
        for name in ("search_by_bow", "sim3_ransac", "search_by_sim3", "optimize_sim3",
                     "search_by_projection"):
            self.saved[name] = getattr(module, name)
            setattr(module, name, getattr(self, "_" + name))

    def restore(self):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)

    def _search_by_bow(self, frame, *a, **k):
        pm = self.saved["search_by_bow"](frame, *a, **k)
        self.current["bow_matches"] = int((pm.feat_pt >= 0).sum())
        return pm

    def _sim3_ransac(self, cam, pc1, pc2, pair_ok, *a, **k):
        res = self.saved["sim3_ransac"](cam, pc1, pc2, pair_ok, *a, **k)
        ev = self.current
        ev.update(pairs=int(pair_ok.sum()), ransac_success=bool(res.success),
                  ransac_inliers=int(res.inliers.sum()))
        return res

    def _search_by_sim3(self, cam, f1, pc1, *a, **k):
        out = self.saved["search_by_sim3"](cam, f1, pc1, *a, **k)
        self.current["sim3_matches"] = int(out[1])
        return out

    def _optimize_sim3(self, cam, S12, pc1, pc2, valid, *a, **k):
        S, inl, n = self.saved["optimize_sim3"](cam, S12, pc1, pc2, valid, *a, **k)
        ev = self.current
        ev["optimize_inliers"] = int(n)
        ev["_support"] = _host(inl) & _host(valid)
        return S, inl, n

    def _search_by_projection(self, cam, Tcw, *a, **k):
        pm = self.saved["search_by_projection"](cam, Tcw, *a, **k)
        ev = self.current
        if "_support" in ev:  # the final gate: right after optimize_sim3
            ev["total"] = int(((_host(pm.feat_pt) >= 0) | ev.pop("_support")).sum())
        return pm


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _watch(closer, device: str, events: list, stages: StageLog, out: str, saves: dict):
    """Record every keyframe `closer` sees into `events`, and save the
    first saves[device] ComputeSim3 inputs under `out`."""
    from orb_slam2_test_tpu_torch import entry

    on_new, query, compute, draw = (closer.on_new_keyframe, closer.db.query_loop_candidates,
                                    closer._compute_and_correct, closer._draw_sim3)

    def on_new_keyframe(m, kf_id):
        ev = {"kf": int(kf_id), "db": len(closer.db.words)}
        stages.current = ev
        out_m, closed = on_new(m, kf_id)
        ev.update(candidate=closer.last_candidate, closed=bool(closed))
        events.append(ev)
        return out_m, closed

    def query_loop_candidates(qv, words, exclude, min_score):
        scored = query(qv, words, exclude, min_score)
        stages.current.update(min_score=float(min_score),
                                      query=[(int(k), float(s)) for k, s in scored])
        return scored

    def draw_sim3(valid, n_iters):
        idx = draw(valid, n_iters)
        stages.current["_draws"] = idx.cpu().numpy()
        return idx

    def compute_and_correct(m, kf_id, cand):
        ev = stages.current
        ev["computed"] = int(cand)
        ok, m2 = compute(m, kf_id, cand)
        ev["closed_by_compute"] = bool(ok)
        draws = ev.pop("_draws", np.zeros((0, 3), np.int64))
        ev["draws"] = len(draws)
        if saves[device] > 0 and "pairs" in ev:  # it reached the Sim3 RANSAC
            saves[device] -= 1
            np.savez_compressed(os.path.join(out, f"compute_{device}_{kf_id}_{cand}.npz"),
                                kf=kf_id, cand=cand, draws=draws, **entry.map_to_numpy(m))
        return ok, m2

    closer.on_new_keyframe = on_new_keyframe
    closer.db.query_loop_candidates = query_loop_candidates
    closer._draw_sim3 = draw_sim3
    closer._compute_and_correct = compute_and_correct


def _unwatch(closer) -> None:
    """Take `_watch`'s wrappers off (a copy of the closer would keep
    them, bound to this one)."""
    for name in ("on_new_keyframe", "_draw_sim3", "_compute_and_correct"):
        del closer.__dict__[name]
    del closer.db.__dict__["query_loop_candidates"]


def first_difference(card: list, cpu: list) -> dict:
    """The first keyframe event, in order, whose decision differs between
    the devices, and the step: the keyframe itself (tracking), the query
    (its candidates), the consistency chain (the candidate), then each
    ComputeSim3 stage's gate, then the closing."""
    for i, (a, b) in enumerate(zip(card, cpu)):
        if a["kf"] != b["kf"]:
            return {"event": i, "step": "keyframe", "card": a, "cpu": b}
        qa, qb = [k for k, _ in a.get("query", [])], [k for k, _ in b.get("query", [])]
        if qa != qb:
            return {"event": i, "step": "query", "card": a, "cpu": b}
        if a["candidate"] != b["candidate"]:
            return {"event": i, "step": "consistency", "card": a, "cpu": b}
        for stage, gate in (("pairs", "pairs"), ("ransac_success", None),
                            ("optimize_inliers", "optimize_inliers"), ("total", "total")):
            va, vb = a.get(stage), b.get(stage)
            pa = va if gate is None or va is None else va >= GATES[gate]
            pb = vb if gate is None or vb is None else vb >= GATES[gate]
            if pa != pb:
                return {"event": i, "step": stage, "card": a, "cpu": b}
        if a["closed"] != b["closed"]:
            return {"event": i, "step": "closed", "card": a, "cpu": b}
    if len(card) != len(cpu):
        return {"event": min(len(card), len(cpu)), "step": "keyframe count",
                "card": len(card), "cpu": len(cpu)}
    return {}


def card_probe(args) -> int:
    import subprocess

    import mono_tum_lockstep as ml
    from orb_slam2_test_tpu_torch import entry
    from orb_slam2_test_tpu_torch.engine import loop_closing as lc
    from orb_slam2_test_tpu_torch.io.datasets import load_tum_mono

    if not torch.cuda.is_available():
        print("loop_miss_probe: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.set_num_threads(ml.THREADS)
    os.makedirs(args.out, exist_ok=True)
    stages = StageLog(lc)
    events = {"card": [], "cpu": []}
    saves = {"card": 0, "cpu": 0}  # the card's, from the copy on
    with tempfile.TemporaryDirectory() as tmp:
        data = args.data or os.path.join(tmp, "tum-mono")
        ml.render(data)
        seq = load_tum_mono(data)
        s = ml.make_port(data, SEED, "cuda")
        _watch(s.tracker.loop_closer, "card", events["card"], stages, args.out, saves)
        copy, copied_at, n_before = None, None, 0
        t0 = time.perf_counter()
        for i, item in enumerate(seq.items):
            ts, img = seq.load(item)
            n_kf = s.tracker.stats["n_kf"]
            s.track_monocular(img, ts)
            if copy is not None:
                copy.process_image_mono(img, ts)
            elif i > AFTER and s.tracker.stats["n_kf"] > n_kf:
                _unwatch(s.tracker.loop_closer)
                copy = entry.tracker_to(s.tracker, "cpu")
                copied_at, n_before = i, len(events["card"])
                saves["card"] = SAVES
                for closer, side in ((s.tracker.loop_closer, "card"), (copy.loop_closer, "cpu")):
                    _watch(closer, side, events[side], stages, args.out, saves)
        s.tracker.drain_backend()
        if copy is not None:
            copy.drain_backend()
    stages.restore()
    res = {"card": card, "seed": SEED, "copied_at_frame": copied_at,
           "events": {"card": events["card"][n_before:], "cpu": events["cpu"]},
           "card_events_before_the_copy": events["card"][:n_before],
           "loops": {"card": s.tracker.stats["loops"],
                     "cpu": copy.stats["loops"] if copy else None},
           "wall_s": time.perf_counter() - t0}
    res["first_difference"] = first_difference(*res["events"].values())
    print(f"seed {SEED} ({card}): copied to the CPU at frame {copied_at}; loops card "
          f"{res['loops']['card']}, CPU copy {res['loops']['cpu']}")
    for name, evs in res["events"].items():
        for e in evs:
            print(f"  {name}: {e}")
    print(f"first difference: {res['first_difference']}")
    with open(os.path.join(args.out, "loop_probe.json"), "w") as f:
        json.dump(res, f, default=str)
    print(card)
    return 0


def _moved(m: dict, seed: int) -> dict:
    """The map with its points and keyframe positions moved SPREAD_STEP m
    along seeded unit directions."""
    rng = np.random.default_rng(seed)
    m = dict(m)
    for f, sl in (("pt_xyz", np.s_[...]), ("kf_Tcw", np.s_[:, :3, 3])):
        x = np.array(m[f], np.float64)
        d = rng.normal(size=x[sl].shape)
        x[sl] = x[sl] + SPREAD_STEP * d / np.linalg.norm(d, axis=-1, keepdims=True)
        m[f] = x.astype(np.float32)
    return m


@contextlib.contextmanager
def _jax_draws(jlc, draws: list):
    """The JAX closer's Sim3 RANSAC drawing draws[0] (a [n_iters, 3]
    array) in place of its own `jax.random.choice`; the RANSAC runs
    eagerly, so that the draws are read at each call."""
    import jax
    import jax.numpy as jnp

    ransac = jlc.sim3_ransac

    def fed(*a, **k):
        choice = jax.random.choice
        jax.random.choice = lambda *_, **__: jnp.asarray(draws[0])
        try:
            with jax.disable_jit():
                return ransac(*a, **k)
        finally:
            jax.random.choice = choice

    jlc.sim3_ransac = fed
    try:
        yield
    finally:
        jlc.sim3_ransac = ransac


def spread(args) -> int:
    """The JAX package's spread of each ComputeSim3 stage at the call, on
    the card's inputs with the card's draws, beside the card's and the
    CPU port's numbers."""
    import jax
    import jax.numpy as jnp
    from orb_slam2_test_tpu.engine import loop_closing as jlc
    from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JCam
    from orb_slam2_test_tpu.slam_map.mapstate import MapState as JMap
    from orb_slam2_test_tpu_torch import entry
    from orb_slam2_test_tpu_torch.engine import loop_closing as lc
    from orb_slam2_test_tpu_torch.system import MONOCULAR, System

    import mono_tum_lockstep as ml

    torch.set_num_threads(ml.THREADS)
    with open(os.path.join(args.spread, "loop_probe.json")) as f:
        probe = json.load(f)
    recorded = {}
    for side, evs in probe["events"].items():
        for e in evs:
            if "computed" in e:
                recorded.setdefault((e["kf"], e["computed"]), {})[side] = e
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        data = args.data or os.path.join(tmp, "tum-mono")
        ml.render(data)
        port = System(os.path.join(data, "settings.yaml"), MONOCULAR, vocabulary=ml.L5,
                      device="cpu")
        closer = port.tracker.loop_closer
        jvoc = ml.make_jax(data).tracker.loop_closer.voc
    cam = closer.cam
    jcam = JCam(**{k: getattr(cam, k) for k in cam._fields})
    tstages, jstages = StageLog(lc), StageLog(jlc)
    draws_now = [None]
    try:
        with _jax_draws(jlc, draws_now):
            for path in sorted(glob.glob(os.path.join(args.spread, "compute_card_*.npz"))):
                z = dict(np.load(path))
                kf, cand, draws = int(z.pop("kf")), int(z.pop("cand")), z.pop("draws")
                draws_now[0] = draws
                row = {"file": os.path.basename(path), "kf": kf, "cand": cand,
                       "recorded": recorded.get((kf, cand), {})}
                # the port on the CPU, the card's draws
                tstages.current = ev = {}
                closer.sim3_sampler = lambda valid, n, d=draws: torch.from_numpy(d)
                ok, _ = closer._compute_and_correct(entry.map_from_numpy(z, "cpu"), kf, cand)
                row["port_cpu"] = {**ev, "closed": bool(ok)}
                # the JAX package, the card's draws, unmoved and moved
                jax_runs = []
                for seed in [None, *range(SPREAD_MOVES)]:
                    mm = z if seed is None else _moved(z, seed)
                    jc = jlc.LoopCloser(jcam, jvoc, fix_scale=closer.fix_scale)
                    jstages.current = ev = {}
                    ok, _ = jc._compute_and_correct(
                        JMap(**{k: jnp.asarray(v) for k, v in mm.items()}), kf, cand)
                    jax_runs.append({**ev, "closed": bool(ok)})
                row["jax_unmoved"] = jax_runs[0]
                row["jax_moved"] = {s: sorted({r.get(s) for r in jax_runs[1:]}, key=str)
                                    for s in STAGES}
                rows.append(row)
                print(f"{row['file']}: the card {row['recorded'].get('card')}; the port on the "
                      f"CPU {row['port_cpu']}; JAX unmoved {row['jax_unmoved']}; JAX under "
                      f"{SPREAD_MOVES} moves of {SPREAD_STEP:g} m {row['jax_moved']}", flush=True)
    finally:
        tstages.restore()
        jstages.restore()
        jax.clear_caches()
    with open(os.path.join(args.spread, "loop_spread.json"), "w") as f:
        json.dump(rows, f, default=str)
    return 0


def loop_run(job: tuple) -> dict:
    """One System alone on the CPU at tracker seed SEED: the JAX
    package's ("jax"), its twin ("twin": map points moved by
    mono_tum_lockstep.TWIN_NOISE of their norm once it initializes) or
    the port's ("port"); each ComputeSim3 attempt's stages, the loops and
    the ATE."""
    data, side = job
    import mono_tum_lockstep as ml

    ml._setup(with_jax=side != "port")
    from orb_slam2_test_tpu_torch.io.datasets import load_tum_mono

    if side == "port":
        from orb_slam2_test_tpu_torch.engine import loop_closing as module
        from orb_slam2_test_tpu_torch.engine.tracking import TrackingState

        s = ml.make_port(data, SEED, "cpu")
    else:
        from orb_slam2_test_tpu.engine import loop_closing as module
        from orb_slam2_test_tpu.engine.tracking import TrackingState

        s = ml.make_jax(data, SEED)
    seq = load_tum_mono(data)
    stages, attempts = StageLog(module), []
    closer = s.tracker.loop_closer
    compute = closer._compute_and_correct

    def compute_and_correct(m, kf_id, cand):
        stages.current = ev = {"kf": int(kf_id), "computed": int(cand)}
        ok, m2 = compute(m, kf_id, cand)
        attempts.append({**ev, "closed": bool(ok)})
        return ok, m2

    closer._compute_and_correct = compute_and_correct
    nudged = side != "twin"
    for item in seq.items:
        ts, img = seq.load(item)
        s.track_monocular(img, ts)
        if not nudged and s.tracker.state == TrackingState.OK:
            ml.nudge_twin(s)
            nudged = True
    ate = ml._ate(s, data, side != "port")  # resolves the keyframes still pending
    stages.restore()
    return {"side": side, "seed": SEED, "attempts": attempts, **ate}


def cpu_runs(args) -> int:
    """The JAX package's own spread of the loop decision (its System at
    SEED and its twin moved 1e-6, relative) beside the port's own run on
    the CPU, in three processes."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import mono_tum_lockstep as ml

    with tempfile.TemporaryDirectory() as tmp:
        data = args.data or os.path.join(tmp, "tum-mono")
        ml.render(data)
        with ProcessPoolExecutor(max_workers=3,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            runs = list(pool.map(loop_run, [(data, side) for side in ("jax", "twin", "port")]))
    for r in runs:
        print(f"{r['side']} at seed {r['seed']}: {r['loops']} loops, ATE {r['ate_m']:.4f} m; "
              f"ComputeSim3 attempts past SearchByBoW: "
              f"{[a for a in r['attempts'] if 'pairs' in a]}", flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "cpu_runs.json"), "w") as f:
            json.dump(runs, f, default=str)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=None, help="the output directory")
    p.add_argument("--data", default=None, help="dataset directory (default: a temporary one)")
    p.add_argument("--spread", default=None, metavar="DIR",
                   help="on the CPU: the JAX package's spread on the card's inputs in DIR")
    p.add_argument("--cpu-runs", action="store_true",
                   help="on the CPU: the JAX System, its twin and the port's System at SEED")
    args = p.parse_args(argv)
    if args.spread:
        return spread(args)
    if args.cpu_runs:
        return cpu_runs(args)
    return card_probe(args)


if __name__ == "__main__":
    sys.exit(main())
