"""`make_synth_data` of the port (tools/make_synth_data.py through the
CLI) against the JAX package's examples/make_synth_data.py, run
in-process on the CPU, at 2-3 frames and a few hundred landmarks: both
write the same tree. Tolerance: exact. Every PNG decodes to equal
pixels (the 16-bit depth too), and times.txt, rgb.txt, depth.txt,
data.csv, groundtruth.txt and settings.yaml are byte-equal. The port's
KITTI dataset written by 2 spawned workers equals the one written in
one process.

Below a radius of 57.14 m (KITTI at --radius 20, TUM at 12 m, EuRoC at
15 m) the port's quads face the path 0.35 rad back, as the JAX package's
did before its commit 4e42fb9, so the JAX script runs with that offset
(`jax_r04_scenes`, tests/test_torch_synthetic_geometry.py); KITTI at its
60 m default runs the JAX script as it is.
"""

import contextlib
import importlib.util
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from orb_slam2_test_tpu_torch import cli

from test_torch_synthetic_geometry import jax_r04_scenes

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# case -> (kind, options, whether the JAX script runs with r04's offset):
# a blackout on the TUM mono case covers the flat frames
CASES = {
    "kitti": ("kitti", ["--frames", "3", "--landmarks", "300", "--radius", "20"], True),
    "kitti-r60": ("kitti", ["--frames", "3", "--landmarks", "300", "--radius", "60"], False),
    "tum-mono": ("tum-mono", ["--frames", "3", "--landmarks", "200", "--blackout-at", "1",
                              "--blackout-len", "1"], True),
    "tum-rgbd": ("tum-rgbd", ["--frames", "2", "--landmarks", "200"], True),
    "euroc": ("euroc", ["--frames", "2", "--landmarks", "200"], True),
}


def load_example(name: str):
    """The JAX package's examples/<name>.py as a module (its `main`
    reads sys.argv)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(mod, argv: list) -> int:
    saved = sys.argv
    sys.argv = [mod.__file__] + argv
    try:
        return mod.main()
    finally:
        sys.argv = saved


def tree(d: str) -> dict:
    """{relative path: decoded pixels (PNG) or bytes} of every file."""
    out = {}
    for root, _, files in os.walk(d):
        for name in files:
            path = os.path.join(root, name)
            rel = os.path.relpath(path, d)
            if name.endswith(".png"):
                out[rel] = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            else:
                with open(path, "rb") as f:
                    out[rel] = f.read()
    return out


def assert_same_tree(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for rel in a:
        if isinstance(a[rel], bytes):
            assert a[rel] == b[rel], rel
        else:
            assert a[rel].dtype == b[rel].dtype, rel
            np.testing.assert_array_equal(a[rel], b[rel], err_msg=rel)


@pytest.fixture(scope="module")
def jax_trees(tmp_path_factory):
    mod = load_example("make_synth_data")
    out = {}
    for case, (kind, opts, r04) in CASES.items():
        d = str(tmp_path_factory.mktemp("jax") / case)
        with jax_r04_scenes() if r04 else contextlib.nullcontext():
            assert run_example(mod, [kind, "--out", d] + opts) == 0
        out[case] = tree(d)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_make_synth_data_matches_jax(case, jax_trees, tmp_path):
    kind, opts, _ = CASES[case]
    d = str(tmp_path / case)
    assert cli.main(["make_synth_data", kind, "--out", d, "--device", "cpu"] + opts) == 0
    port = tree(d)
    assert_same_tree(port, jax_trees[case])
    if kind == "tum-rgbd":
        depth = [v for k, v in port.items() if k.startswith("depth") and k.endswith(".png")]
        assert depth and all(x.dtype == np.uint16 and x.max() > 0 for x in depth)
    if kind == "tum-mono":
        flat = port["rgb/1000.100000.png"]
        assert (flat == 16).all()


def test_make_synth_data_kitti_workers(jax_trees, tmp_path):
    """--workers 2 renders and writes chunks in spawned processes: the
    same files as one process (and so as the JAX script's)."""
    d = str(tmp_path / "kitti")
    assert cli.main(["make_synth_data", "kitti", "--out", d, "--workers", "2",
                     "--device", "cpu"] + CASES["kitti"][1]) == 0
    assert_same_tree(tree(d), jax_trees["kitti"])


@pytest.mark.parametrize("argv", [
    ["make_synth_data", "tum-mono", "--frames", "1", "--out"],
    ["build_vocab", "--out"],
    ["vocab_recall", "--vocab", "v.npz", "--out", "r.json"],
    ["ba_window_sweep", "--out"],
], ids=lambda a: a[0])
def test_tools_need_a_card_by_default(argv, tmp_path, monkeypatch):
    """Without --device each tool asks for the card, and raises without
    one before it reads or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if argv[0] in ("vocab_recall", "ba_window_sweep"):
        argv = argv[:1] + [str(tmp_path / "no_dataset")] + argv[1:]
    if argv[-1] == "--out":
        argv = argv + [str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        cli.main(argv)
    assert os.listdir(tmp_path) == []
