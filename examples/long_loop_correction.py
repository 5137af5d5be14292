"""The 2,600-frame KITTI loop's first correction through both packages on the CPU.

    JAX_PLATFORMS=cpu python examples/long_loop_correction.py DIR/first_correction.npz

examples/kitti_loop_run.py saves the inputs of its run's first loop
correction (the map as the card held it, the two keyframes, the loop's
Sim3), the relative trajectory of the frames so far and their truth.
This runs `_correct_loop_device` on those inputs in the JAX package and
in the port, each as shipped and with its loop connections left out of
the essential graph (`utils.loop_probes.loop_connections_left_out`:
the covisibility edges from the links before SearchAndFuse, as
tests/test_torch_loop_connections.py does on the 22-keyframe map), and
prints the ATE (SE3) over the frames so far before the correction and
after each, the largest gap between the two packages' live poses and the
share of their links that are equal. The JAX package's own spread
beside it: the JAX correction on the inputs with the map's points and
keyframe positions moved MOVE_STEP m along seeded directions (MOVES
times), against its result on the inputs as they are.
"""

from __future__ import annotations

import os
import sys
import time
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

THREADS = 2
POSE_FIELDS = ("kf_Tcw", "kf_valid", "kf_parent", "kf_Tcp", "kf_pt_idx")
MOVES = 2
MOVE_STEP = 1e-6


def _moved(m: dict, seed: int) -> dict:
    """The map with its points and keyframe positions moved MOVE_STEP m
    along seeded unit directions."""
    rng = np.random.default_rng(seed)
    m = dict(m)
    for f, sl in (("pt_xyz", np.s_[...]), ("kf_Tcw", np.s_[:, :3, 3])):
        x = np.array(m[f], np.float64)
        d = rng.normal(size=x[sl].shape)
        x[sl] = x[sl] + MOVE_STEP * d / np.linalg.norm(d, axis=-1, keepdims=True)
        m[f] = x.astype(np.float32)
    return m


def main(argv=None) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from orb_slam2_test_tpu.engine import loop_closing as jlc
    from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JCam
    from orb_slam2_test_tpu.slam_map.mapstate import MapState as JMap
    from orb_slam2_test_tpu_torch import entry
    from orb_slam2_test_tpu_torch.engine import loop_closing as tlc
    from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam2_test_tpu_torch.utils.loop_probes import (
        ate, loop_connections_left_out, trajectory_on)

    path = (argv or sys.argv[1:])[0]
    torch.set_num_threads(THREADS)
    z = dict(np.load(path))
    cam = PinholeCamera(**{f: z.pop("cam_" + f).item() for f in PinholeCamera._fields})
    kf, cand, fix = int(z.pop("kf")), int(z.pop("cand")), bool(z.pop("fix_scale"))
    S12 = z.pop("S12")
    rel = list(zip(z.pop("rel_t"), z.pop("rel_ref"), z.pop("rel_T")))
    T_true = z.pop("T_true")
    m = z
    n = len(rel)
    K, P = m["kf_valid"].shape[0], m["pt_valid"].shape[0]
    print(f"first correction: keyframe {kf} to {cand}, K {K}, P {P}, "
          f"{int(m['kf_valid'].sum())} live keyframes, {int(m['pt_valid'].sum())} live points, "
          f"{n} frames so far, fix_scale {fix}", flush=True)

    def ate_on(poses: dict) -> float:
        return ate(trajectory_on(rel, SimpleNamespace(**poses)), T_true)["rmse"]

    def jax_correct(mm=m):
        out = jlc._correct_loop_device(
            JCam(**cam._asdict()), JMap(**{k: jnp.asarray(v) for k, v in mm.items()}),
            jnp.asarray(kf, jnp.int32), jnp.asarray(cand, jnp.int32), jnp.asarray(S12), fix)
        return {f: np.asarray(getattr(out, f)) for f in POSE_FIELDS}

    def port_correct():
        out = tlc._correct_loop_device(cam, entry.map_from_numpy(m, "cpu"), torch.tensor(kf),
                                       torch.tensor(cand), torch.from_numpy(S12), fix)
        return {f: getattr(out, f).numpy() for f in POSE_FIELDS}

    live = m["kf_valid"]

    def gaps(a: dict, b: dict) -> str:
        pose = np.abs(a["kf_Tcw"][live] - b["kf_Tcw"][live]).max()
        links = (a["kf_pt_idx"][live] == b["kf_pt_idx"][live]).mean()
        return f"live poses {pose:.2e}, links {links:.4%} equal"

    before = ate_on(m)
    for variant in ("shipped", "left out"):
        res = {}
        runs = [("jax", jax_correct, jlc), ("port", port_correct, tlc)]
        runs += [(f"jax moved {i}", lambda i=i: jax_correct(_moved(m, i)), jlc)
                 for i in range(MOVES)]
        for side, fn, module in runs:
            t0 = time.perf_counter()
            if variant == "shipped":
                out = fn()
            else:
                with loop_connections_left_out(module):
                    jax.clear_caches()
                    out = fn()
                jax.clear_caches()
            res[side] = out
            print(f"{side} {variant}: ATE over the {n} frames {before:.4f} -> "
                  f"{ate_on(out):.4f} m ({time.perf_counter() - t0:.1f} s)", flush=True)
        print(f"{variant}: the port against the JAX package: {gaps(res['port'], res['jax'])}; "
              f"the JAX package moved {MOVE_STEP:g} m against itself: "
              + "; ".join(gaps(res[f"jax moved {i}"], res["jax"]) for i in range(MOVES)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
