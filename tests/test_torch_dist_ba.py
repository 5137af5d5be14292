"""The port's distributed bundle adjustment (parallel/dist_ba.py,
parallel/multihost.py) against the JAX package's, on the CPU.

The JAX side runs on its 8-device virtual CPU mesh (tests/conftest.py);
the port's one-process mesh holds the same number of shards. The
problems are tests/test_ba.py's (`make_ba_problem`: 6 cameras, 96
points, every point seen by every camera, 2 cameras fixed), carried
across as numpy arrays.

- `shard_problem` at 1, 4 and 8 shards: every field equal.
- `dist_bundle_adjust` at 1, 4 and 8 shards, 12 LM iterations: poses
  atol 1e-4, points within 1e-3 on >= 99%, cost rtol 1e-4 (measured:
  poses 4.1e-7 / 5.7e-7 / 2.9e-6, points 1.2e-5 / 2.6e-5 / 1.3e-4,
  cost 2.4e-6 / 3.1e-6 / 1.5e-6 relative); every free pose within
  0.02 rad of the truth (tests/test_dist_ba.py).
- 8 shards against 1 in the port: poses atol 5e-4 (tests/test_dist_ba.py:47).
- The collectives: 1 + (cg_iters + 1) + 1 per LM iteration, 15 at the
  default 12, the JAX program's count.
- Two calibrations merged into per-camera [C] intrinsics
  (`multi_map.merge_problems` of the JAX package) against JAX on a
  4-device mesh: poses atol 1e-4 (measured 9.5e-6).
- A real multi-process run: 2 and 4 ranks spawned with gloo through
  `multihost.initialize_from_env`, each rank holding its block
  (`make_global_problem`), against the one-process run of the same
  shard count: bit-equal at 2 ranks (a sum of two addends does not
  depend on their order); at 4 ranks gloo's ring adds in another order
  than the one-process form, held to poses atol 1e-5 (measured 2.7e-7).
- No silent fallback: a CUDA mesh without a card raises, a single
  process initializes nothing, a distributed mesh of the wrong size
  raises.
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_test_tpu.geometry.se3 import se3_inverse, se3_log
from orb_slam2_test_tpu.parallel import dist_ba as jd
from orb_slam2_test_tpu.parallel.multi_map import CompactProblem as JCompact
from orb_slam2_test_tpu.parallel.multi_map import merge_problems as j_merge
from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.parallel import dist_ba as td
from orb_slam2_test_tpu_torch.parallel import multihost
from orb_slam2_test_tpu_torch.solvers.ba_core import BAProblem

from test_ba import make_ba_problem

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 12
SHARDS = [1, 4, 8]


def _problem(seed=0, **kw):
    kw = dict(dict(n_cams=6, n_pts=96, noise=0.4, n_fixed=2), **kw)
    cam, prob, T_true, _ = make_ba_problem(np.random.default_rng(seed), **kw)
    return cam, prob, np.asarray(T_true)


@pytest.fixture(scope="module")
def problem():
    cam, prob, T_true = _problem()
    tprob, tcam = entry.ba_problem_from_numpy(prob, cam, "cpu")
    return cam, prob, tcam, tprob, T_true


@pytest.fixture(scope="module")
def jax_runs(problem):
    cam, prob = problem[:2]
    out = {}
    for n in SHARDS:
        r = jd.dist_bundle_adjust(jd.shard_problem(prob, n), cam, jd.make_ba_mesh(n), iters=ITERS)
        out[n] = [np.asarray(x) for x in r]
    return out


@pytest.fixture(scope="module")
def port_runs(problem):
    tcam, tprob = problem[2:4]
    return {n: td.dist_bundle_adjust(td.shard_problem(tprob, n), tcam,
                                     td.make_ba_mesh(n, "cpu"), iters=ITERS)
            for n in SHARDS}


@pytest.mark.parametrize("n", SHARDS)
def test_shard_problem_matches_jax(problem, n):
    prob, tprob = problem[1], problem[3]
    j, t = jd.shard_problem(prob, n), td.shard_problem(tprob, n)
    for f, a, b in zip(BAProblem._fields, j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)


@pytest.mark.parametrize("n", SHARDS)
def test_dist_bundle_adjust_matches_jax(jax_runs, port_runs, n):
    jT, jX, jc = jax_runs[n]
    tT, tX, tc = (x.numpy() for x in port_runs[n])
    np.testing.assert_allclose(tT, jT, atol=1e-4)
    gap = np.abs(tX - jX).max(-1)
    assert (gap <= 1e-3).mean() >= 0.99, gap.max()
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-4)


@pytest.mark.parametrize("n", SHARDS)
def test_dist_bundle_adjust_reaches_truth(problem, port_runs, n):
    T_true = problem[4]
    Tcw = port_runs[n][0].numpy()
    for c in range(1, 6):
        err = np.asarray(se3_log(jnp.asarray(Tcw[c]) @ se3_inverse(jnp.asarray(T_true[c]))))
        assert np.linalg.norm(err[:3]) < 0.02, (n, c)


def test_eight_shards_match_one():
    cam, prob, _ = _problem(seed=1, n_cams=5, n_pts=64, noise=0.3)
    tprob, tcam = entry.ba_problem_from_numpy(prob, cam, "cpu")
    r1 = td.dist_bundle_adjust(td.shard_problem(tprob, 1), tcam, td.make_ba_mesh(1, "cpu"),
                               iters=8)
    r8 = td.dist_bundle_adjust(td.shard_problem(tprob, 8), tcam, td.make_ba_mesh(8, "cpu"),
                               iters=8)
    np.testing.assert_allclose(r8[0].numpy(), r1[0].numpy(), atol=5e-4)
    assert abs(float(r1[2]) - float(r8[2])) < 2.0


@pytest.mark.parametrize("cg_iters", [12, 5])
def test_collectives_per_lm_iteration(problem, cg_iters):
    tcam, tprob = problem[2:4]
    td.PSUM.calls = 0
    td.dist_bundle_adjust(td.shard_problem(tprob, 4), tcam, td.make_ba_mesh(4, "cpu"),
                          iters=3, cg_iters=cg_iters)
    assert td.PSUM.calls == 3 * (1 + (cg_iters + 1) + 1)


def test_per_camera_intrinsics_match_jax():
    """Two calibrations merged by the JAX package's merge_problems: the
    camera fields become [C] arrays, gathered per observation."""
    parts, cams = [], []
    for seed, fx in ((2, 520.0), (3, 710.0)):
        cam, prob, _ = _problem(seed=seed, n_cams=4, n_pts=48)
        cam = cam._replace(fx=fx, fy=fx - 5.0, cx=cam.cx - 8.0)
        # the observations stay make_ba_problem's: both packages solve
        # the same mismatched problem, and only have to agree
        parts.append(JCompact(prob, None, None))
        cams.append(cam)
    merged = j_merge(parts, cams)
    assert np.asarray(merged.cam.fx).shape == (8,)
    jr = jd.dist_bundle_adjust(jd.shard_problem(merged.prob, 4), merged.cam, jd.make_ba_mesh(4),
                               iters=6)
    tprob, tcam = entry.ba_problem_from_numpy(merged.prob, merged.cam, "cpu")
    assert torch.is_tensor(tcam.fx) and tcam.fx.shape == (8,)
    tr = td.dist_bundle_adjust(td.shard_problem(tprob, 4), tcam, td.make_ba_mesh(4, "cpu"),
                               iters=6)
    np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr[0]), atol=1e-4)
    np.testing.assert_allclose(float(tr[2]), float(jr[2]), rtol=1e-4)


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {root!r})
    from orb_slam2_test_tpu_torch.parallel import dist_ba, multihost
    from orb_slam2_test_tpu_torch.solvers.ba_core import BAProblem
    from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera

    assert multihost.initialize_from_env(device="cpu")
    mesh = multihost.global_ba_mesh("cpu")
    z = np.load({prob!r})
    prob = BAProblem(*[torch.from_numpy(z[f]) for f in BAProblem._fields])
    cam = PinholeCamera(**{{k: float(z["cam_" + k]) for k in ("fx", "fy", "cx", "cy", "bf")}})
    mine = multihost.make_global_problem(dist_ba.shard_problem(prob, mesh.size), mesh)
    Tcw, xyz, cost = dist_ba.dist_bundle_adjust(mine, cam, mesh, iters=8)
    np.savez({out!r} % mesh.rank, Tcw=Tcw.numpy(), xyz=xyz.numpy(), cost=cost.numpy(),
             size=mesh.size, calls=dist_ba.PSUM.calls)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", [2, 4])
def test_multi_process_gloo_matches_one_process(tmp_path, world):
    cam, prob, _ = _problem(seed=7, n_cams=5, n_pts=64, noise=0.3)
    tprob, tcam = entry.ba_problem_from_numpy(prob, cam, "cpu")
    path = str(tmp_path / "prob.npz")
    np.savez(path, **{f: x.numpy() for f, x in zip(BAProblem._fields, tprob)},
             **{"cam_" + k: getattr(tcam, k) for k in ("fx", "fy", "cx", "cy", "bf")})
    out = str(tmp_path / "rank%d.npz")
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(root=ROOT, prob=path, out=out))
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, SLAM_COORDINATOR=f"127.0.0.1:{port}",
                   SLAM_NUM_PROCS=str(world), SLAM_PROC_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, str(script)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    results = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=120)
            results.append((p.returncode, so.decode(), se.decode()))
    finally:
        for p in procs:
            p.kill()
    for rc, so, se in results:
        assert rc == 0, f"worker failed:\n{so}\n{se[-3000:]}"

    one = td.dist_bundle_adjust(td.shard_problem(tprob, world), tcam,
                                td.make_ba_mesh(world, "cpu"), iters=8)
    ranks = [np.load(out % r) for r in range(world)]
    assert all(int(z["size"]) == world and int(z["calls"]) == 8 * 15 for z in ranks)
    xyz = np.concatenate([z["xyz"] for z in ranks])
    if world == 2:
        for z in ranks:
            np.testing.assert_array_equal(z["Tcw"], one[0].numpy())
            assert float(z["cost"]) == float(one[2])
        np.testing.assert_array_equal(xyz, one[1].numpy())
    else:
        gap = max(np.abs(z["Tcw"] - one[0].numpy()).max() for z in ranks)
        print(f"{world} gloo ranks vs {world} shards in one process: poses {gap:.2e}")
        for z in ranks:
            np.testing.assert_allclose(z["Tcw"], one[0].numpy(), atol=1e-5)
        np.testing.assert_allclose(xyz, one[1].numpy(), atol=1e-4)


def test_no_silent_fallback(monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            td.make_ba_mesh(1, "cuda")
        with pytest.raises(RuntimeError, match="CUDA card"):
            multihost.initialize_from_env("127.0.0.1:1", 2, 0, device="cuda")
    assert multihost.initialize_from_env(num_processes=1) is False
    monkeypatch.setattr(td, "distributed", lambda: True)
    monkeypatch.setattr(td.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(td.dist, "get_rank", lambda: 0)
    with pytest.raises(ValueError, match="spans 2 ranks"):
        td.make_ba_mesh(4, "cpu")
    mesh = td.make_ba_mesh(None, "cpu")
    assert mesh.size == 2 and mesh.distributed and mesh.local_shards == 1
    with pytest.raises(ValueError, match="one shard"):
        td._psum([torch.zeros(1), torch.zeros(1)], mesh)


def test_dryrun_multichip_on_the_cpu():
    out = entry.dryrun_multichip(2, "cpu")
    assert np.isfinite(out["cost"])
    assert out["descs"].shape == (2, 64, 8)
