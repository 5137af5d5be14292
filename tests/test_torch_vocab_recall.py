"""`vocab_recall` of the port (tools/vocab_recall.py) against the JAX
package's examples/vocab_recall.py, run in-process on the CPU, on a
small KITTI-format ring written by the port's `make_synth_data` (20
stereo frames at 1241x376, radius 10 m, 1.3 laps; every second frame,
frames 14-18 revisit the start) with the packaged L5 and L6
vocabularies.

The JAX script's positions are not the camera centres (ROADMAP queue
3): it takes -R^T t of the ground truth's camera-to-world pose, which
on a ring is the same point for every frame, so every candidate counts
as a hit. The port measures against the true centres (`true_centers`);
the comparisons with the JAX report feed the port's `report` the JAX
script's positions.

- The `recall` core fed the JAX run's own descriptors and positions
  gives exactly the JAX report (tolerance: exact).
- End to end (the port's extraction, whose bf16 BRIEF selection flips
  a few bits): each recall within 1 / n_queries of the JAX report's,
  the gap printed.
- The fault: the JAX positions span under 0.5 m where the true centres
  span the ring's 20 m; the port's CLI report, against the true
  centres, counts no more hits than the JAX script's.
"""

import json

import numpy as np
import pytest
import torch

from orb_slam2_test_tpu.engine import frame as jframe
from orb_slam2_test_tpu_torch import cli
from orb_slam2_test_tpu_torch.io.datasets import load_kitti
from orb_slam2_test_tpu_torch.io.trajectory import load_trajectory_tum
from orb_slam2_test_tpu_torch.tools import vocab_recall
from orb_slam2_test_tpu_torch.utils.synthetic import make_loop_trajectory

from test_torch_make_synth_data import ROOT, load_example, run_example

torch.set_num_threads(2)

VOCABS = [f"{ROOT}/orb_slam2_test_tpu/data/vocab_k10_L5.npz",
          f"{ROOT}/orb_slam2_test_tpu/data/vocab_k10_L6.npz"]
OPTS = ["--split", "14", "--stride", "2", "--n-features", "1000"]
IDX = list(range(0, 20, 2))


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ring") / "kitti")
    assert cli.main(["make_synth_data", "kitti", "--out", d, "--frames", "20", "--landmarks",
                     "600", "--radius", "10", "--revolutions", "1.3", "--device", "cpu"]) == 0
    return d


def jax_positions(d: str) -> dict:
    """The JAX script's positions of the frames: -R^T t of each ground
    truth pose (camera to world)."""
    gt = load_trajectory_tum(f"{d}/groundtruth.txt")
    return {i: -gt[i][1][:3, :3].T @ gt[i][1][:3, 3] for i in IDX}


@pytest.fixture(scope="module")
def jax_run(ring, tmp_path_factory):
    """The JAX script's report on the ring, and the descriptors its
    extraction gave (recorded by wrapping `build_frame_mono`, which its
    main imports when it runs)."""
    mod = load_example("vocab_recall")
    out = str(tmp_path_factory.mktemp("jax") / "recall.json")
    descs = []
    build = jframe.build_frame_mono

    def recorded(*a, **k):
        f = build(*a, **k)
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
        return f

    jframe.build_frame_mono = recorded
    try:
        argv = [ring] + sum((["--vocab", v] for v in VOCABS), []) + OPTS + ["--out", out]
        assert run_example(mod, argv) == 0
    finally:
        jframe.build_frame_mono = build
    with open(out) as f:
        return json.load(f), descs


@pytest.fixture(scope="module")
def port_run(ring, tmp_path_factory):
    """The port's CLI report on the ring, and what its
    `extract_sequence` returned (recorded by wrapping it)."""
    out = str(tmp_path_factory.mktemp("port") / "recall.json")
    extracted = []
    extract = vocab_recall.extract_sequence

    def recorded(*a, **k):
        extracted.append(extract(*a, **k))
        return extracted[-1]

    vocab_recall.extract_sequence = recorded
    try:
        argv = ["vocab_recall", ring] + sum((["--vocab", v] for v in VOCABS), []) + OPTS
        assert cli.main(argv + ["--out", out, "--device", "cpu"]) == 0
    finally:
        vocab_recall.extract_sequence = extract
    with open(out) as f:
        return json.load(f), extracted[0]


def test_recall_core_on_jax_descriptors_is_the_jax_report(ring, jax_run):
    report, jdescs = jax_run
    assert len(IDX) == len(jdescs) == report["n_db"] + report["n_queries"]
    port = vocab_recall.report(ring, IDX, dict(zip(IDX, jdescs)), jax_positions(ring), VOCABS,
                               14, 8.0, "cpu", log=lambda *a: None)
    assert port == report
    assert report["n_queries"] == 3 and report["vocabs"]["vocab_k10_L6.npz"]["top5_recall"] > 0


def test_recall_end_to_end_within_one_query(ring, jax_run, port_run):
    report, _ = jax_run
    idx, descs, _ = port_run[1]
    assert idx == IDX
    port = vocab_recall.report(ring, idx, descs, jax_positions(ring), VOCABS, 14, 8.0, "cpu",
                               log=lambda *a: None)
    assert {k: v for k, v in port.items() if k != "vocabs"} == \
        {k: v for k, v in report.items() if k != "vocabs"}
    assert port["vocabs"].keys() == report["vocabs"].keys()
    for name, r in port["vocabs"].items():
        j = report["vocabs"][name]
        assert r["n_words"] == j["n_words"]
        for key in ("top1_recall", "top5_recall"):
            gap = abs(r[key] - j[key])
            print(f"{name} {key}: port {r[key]}, JAX {j[key]}, gap {gap}")
            assert gap <= 1.0 / report["n_queries"] + 1e-9


def test_jax_positions_are_not_the_centres(ring, jax_run, port_run):
    report, _ = jax_run
    jpos = np.stack(list(jax_positions(ring).values()))
    centers = vocab_recall.true_centers(ring, load_kitti(ring), IDX)
    true = np.stack([centers[i] for i in IDX])
    T = make_loop_trajectory(20, 10.0, 1.3)[IDX]
    np.testing.assert_allclose(true, -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3]),
                               atol=1e-5)
    assert np.ptp(jpos, axis=0).max() < 0.5 and np.ptp(true, axis=0).max() > 19.0
    # every query revisits a database frame within 8 m; none within 0.1 m
    assert vocab_recall.reachable(centers, IDX[:7], IDX[7:], 8.0) == 3
    assert vocab_recall.reachable(centers, IDX[:7], IDX[7:], 0.1) == 0

    port, (_, _, port_centers) = port_run
    assert all(np.array_equal(port_centers[i], centers[i]) for i in IDX)
    assert port.keys() == report.keys()
    for name, r in port["vocabs"].items():
        assert r.keys() == report["vocabs"][name].keys()
        for key in ("top1_recall", "top5_recall"):
            print(f"{name} {key}: true centres {r[key]}, the JAX positions "
                  f"{report['vocabs'][name][key]}")
            assert r[key] <= report["vocabs"][name][key]
