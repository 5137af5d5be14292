"""`build_vocab` of the port (tools/build_vocab.py) against the JAX
package's examples/build_vocab.py, run in-process on the CPU, on a
sweep of 2 scenes x 2 frames x 300 features.

- The sweep's poses (float32 `se3_exp` of each side) within 1e-6 and
  its images within 0.01 grey levels (both measured equal at this size;
  over the default 24 x 8 sweep the poses differ by up to 8.6e-7 and the
  images by up to 0.003).
- Extraction: per frame equal feature counts and at most 2 flipped bits
  per descriptor (the port's one-pass bf16 BRIEF selection), from the
  sweep and from an image directory.
- Training: on the JAX descriptors the port's tree, idf weights and
  re-transform word count equal the JAX package's exactly.
- The CLI's npz and --text-out round-trip, and the default --out lies
  outside the JAX package, whose own default (read from its parser,
  never run) writes an L5 tree over the packaged L6 file.
"""

import argparse
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_test_tpu.bow import vocabulary as jvoc
from orb_slam2_test_tpu.geometry.se3 import se3_exp as jse3_exp
from orb_slam2_test_tpu_torch import cli
from orb_slam2_test_tpu_torch.bow import vocabulary as tvoc
from orb_slam2_test_tpu_torch.tools import build_vocab

from test_torch_bow import _assert_same_vocabulary
from test_torch_frontend import _flipped_bits
from test_torch_make_synth_data import ROOT, load_example

torch.set_num_threads(2)

SWEEP = dict(n_scenes=2, frames_per_scene=2, n_features=300, seed=0)


@pytest.fixture(scope="module")
def jax_sweep():
    """The JAX script's synthetic sweep, each frame's image and
    descriptors recorded by wrapping its `_extract`."""
    mod = load_example("build_vocab")
    frames = []
    extract = mod._extract

    def recorded(img, cam, n_features):
        d = extract(img, cam, n_features)
        frames.append((np.array(img), d))
        return d

    mod._extract = recorded
    desc = mod._synthetic_descriptors(*SWEEP.values())
    np.testing.assert_array_equal(desc, np.concatenate([d for _, d in frames]))
    return mod, frames, desc


def test_sweep_images_match_jax(jax_sweep):
    _, frames, _ = jax_sweep
    port = list(build_vocab.synthetic_images(SWEEP["n_scenes"], SWEEP["frames_per_scene"],
                                             SWEEP["seed"]))
    assert len(port) == len(frames)
    for (scene, i, cam, Tcw, img), (jimg, _) in zip(port, frames):
        jT = np.asarray(jse3_exp(jnp.asarray(_scene_step(scene) * i, jnp.float32)))
        np.testing.assert_allclose(Tcw, jT, atol=1e-6, rtol=0)
        np.testing.assert_allclose(img, jimg, atol=0.01, rtol=0)
        assert (cam.width, cam.height) == (640, 480)


def _scene_step(scene: int) -> np.ndarray:
    """The seeded per-frame step of a sweep scene, drawn as both scripts
    draw it (after the landmarks and their intensities)."""
    rng = np.random.default_rng(SWEEP["seed"] + scene)
    n_lm = int(rng.integers(300, 700))
    rng.uniform(-6.0, 6.0, size=(n_lm, 2))
    rng.uniform(4.0, 10.0, size=(n_lm, 1))
    rng.uniform(120.0, 255.0, size=(n_lm,))
    return np.array([rng.uniform(0.05, 0.2), rng.uniform(-0.05, 0.05),
                     rng.uniform(-0.02, 0.02), rng.uniform(-0.004, 0.004),
                     rng.uniform(-0.006, 0.006), rng.uniform(-0.004, 0.004)])


def test_sweep_descriptors_match_jax(jax_sweep):
    _, frames, _ = jax_sweep
    port = build_vocab.synthetic_descriptors(*SWEEP.values(), device="cpu",
                                             log=lambda *a: None)
    assert [len(d) for d in port] == [len(d) for _, d in frames]
    for p, (_, j) in zip(port, frames):
        assert p.dtype == np.uint32
        assert _flipped_bits(p, j).max() <= 2


def test_dataset_descriptors_match_jax(jax_sweep, tmp_path):
    """--dataset DIR: the images of a directory (one subdirectory deep)."""
    mod, frames, _ = jax_sweep
    os.makedirs(tmp_path / "image_0")
    for i, (img, _) in enumerate(frames[:2]):
        cv2.imwrite(str(tmp_path / "image_0" / f"{i:06d}.png"), img.astype(np.uint8))
    j = []
    extract = mod._extract
    mod._extract = lambda img, cam, n: j.append(extract(img, cam, n)) or j[-1]
    try:
        mod._dataset_descriptors(str(tmp_path), 10, 300)
    finally:
        mod._extract = extract
    port = build_vocab.dataset_descriptors(str(tmp_path), 10, 300, "cpu", log=lambda *a: None)
    assert [len(d) for d in port] == [len(d) for d in j]
    for p, q in zip(port, j):
        assert _flipped_bits(p, q).max() <= 2


def test_training_matches_jax_on_shared_descriptors(jax_sweep):
    _, _, desc = jax_sweep
    jv = jvoc.build_vocabulary(desc, k=10, depth=3, seed=0)
    tv, stages = build_vocab.train(desc, 10, 3, 0, "cpu", log=lambda *a: None)
    _assert_same_vocabulary(tv, jv)
    assert set(stages) == {"kmeans_s", "idf_s"}
    jw, _ = jvoc.transform(jv, jnp.asarray(desc[:20000]), jnp.ones(min(len(desc), 20000), bool))
    jw = np.asarray(jw)
    assert build_vocab.distinct_words(tv, desc[:20000], "cpu") == len(np.unique(jw[jw >= 0]))


def test_cli_round_trips_npz_and_text(tmp_path):
    out, text = str(tmp_path / "v" / "voc.npz"), str(tmp_path / "voc.txt")
    argv = ["build_vocab", "--n-scenes", "1", "--frames-per-scene", "2", "--n-features", "300",
            "--depth", "3", "--out", out, "--text-out", text, "--device", "cpu"]
    summary = build_vocab.run(cli.build_parser().parse_args(argv), log=lambda *a: None)
    voc = summary["vocabulary"]
    assert summary["n_descriptors"] == sum(len(d) for d in summary["frames"])
    assert 1 < summary["distinct_words"] <= voc.n_words
    for loaded in (tvoc.load_vocabulary(out), tvoc.load_vocabulary(text)):
        for f in ("node_desc", "node_children", "node_is_leaf", "leaf_word", "word_weight"):
            np.testing.assert_array_equal(getattr(loaded, f), getattr(voc, f), err_msg=f)
        assert (loaded.k, loaded.depth) == (10, 3)
    assert cli.main(argv) == 0  # the subcommand itself


class _Parsed(Exception):
    pass


def test_default_out_outside_the_jax_package(monkeypatch):
    """The JAX script's parser (captured when its main parses, before it
    does anything) defaults --out to the packaged L6 vocabulary and
    --depth to 5: a run with no arguments overwrites the System's
    default 793,594-word L6 tree with an L5 one (ROADMAP queue 3). The
    port's default is runs/vocab/vocab_k10_L5.npz."""
    mod = load_example("build_vocab")

    def capture(self, *a, **k):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as parsed:
        mod.main()
    monkeypatch.undo()
    defaults = {a.dest: a.default for a in parsed.value.args[0]._actions}
    packaged = os.path.join(ROOT, "orb_slam2_test_tpu", "data", "vocab_k10_L6.npz")
    assert os.path.samefile(defaults["out"], packaged)
    assert defaults["depth"] == 5

    args = cli.build_parser().parse_args(["build_vocab"])
    assert args.out is None and args.depth == 5 and args.device == "cuda"
    port_out = os.path.abspath(build_vocab.default_out(args.k, args.depth))
    assert port_out.endswith(os.path.join("runs", "vocab", "vocab_k10_L5.npz"))
    assert not port_out.startswith(os.path.join(ROOT, "orb_slam2_test_tpu") + os.sep)
