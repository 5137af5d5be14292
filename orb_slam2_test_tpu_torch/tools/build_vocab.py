"""Train and package a BoW vocabulary from the port's own extractor.

The counterpart of the JAX package's examples/build_vocab.py. The
reference ships ORBvoc.txt, trained on OpenCV ORB descriptors, which do
not match this framework's BRIEF pattern, so the vocabulary is trained
from the port's own `engine/frame.build_frame_mono` (kernel 1: one
launch per training frame), on `--device`:

  python -m orb_slam2_test_tpu_torch.cli build_vocab                  # synthetic sweep
  python -m orb_slam2_test_tpu_torch.cli build_vocab --dataset DIR    # real images

The tree is a hierarchical binary k-means on the host
(`bow.vocabulary.build_tree`), its idf weights `transform` the training
set on the device (`idf_weights`), and it is saved as an npz (and, with
--text-out, in DBoW2's text format). The default --out is
runs/vocab/vocab_k<K>_L<DEPTH>.npz: the JAX script's default writes its
L5 tree over the packaged L6 file, orb_slam2_test_tpu/data/vocab_k10_L6.npz,
which the System loads by default; the port writes nothing into the JAX
package.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch

from orb_slam2_test_tpu_torch.bow.vocabulary import (
    Vocabulary,
    build_tree,
    idf_weights,
    save_text_vocabulary,
    save_vocabulary_npz,
    transform,
)
from orb_slam2_test_tpu_torch.engine.frame import build_frame_mono
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.geometry.se3 import se3_exp
from orb_slam2_test_tpu_torch.tools import torch_device
from orb_slam2_test_tpu_torch.utils.synthetic import (
    _landmark_patches,
    default_camera,
    make_landmarks,
    render_frame,
)


def extract(img: np.ndarray, cam: PinholeCamera, n_features: int,
            device: torch.device | str) -> np.ndarray:
    """[n, 8] uint32 descriptors of the valid features of one grayscale
    image (uint8 or float32), extracted on `device`."""
    f = build_frame_mono(torch.from_numpy(np.ascontiguousarray(img)).to(device), 0.0, cam,
                         n_features=n_features)
    return f.desc.cpu().numpy().view(np.uint32)[f.valid.cpu().numpy()]


def synthetic_images(n_scenes: int, frames_per_scene: int, seed: int):
    """The multi-scene synthetic sweep: every scene gets its own landmark
    layout AND its own texture set (`make_sequence` reuses one texture
    seed, too narrow for a vocabulary). Yields (scene, frame, cam,
    Tcw, image [480, 640] float32); the poses are float32 `se3_exp`s
    of the scene's seeded step times the frame index."""
    cam = default_camera(640, 480)
    for scene in range(n_scenes):
        rng = np.random.default_rng(seed + scene)
        n_lm = int(rng.integers(300, 700))
        landmarks = make_landmarks(rng, n_lm)
        intensities = rng.uniform(120.0, 255.0, size=(n_lm,)).astype(np.float32)
        patches = _landmark_patches(n_lm, seed=1000 + scene)
        step = np.array([
            rng.uniform(0.05, 0.2),
            rng.uniform(-0.05, 0.05),
            rng.uniform(-0.02, 0.02),
            rng.uniform(-0.004, 0.004),
            rng.uniform(-0.006, 0.006),
            rng.uniform(-0.004, 0.004),
        ])
        for i in range(frames_per_scene):
            Tcw = se3_exp(torch.tensor(step * i, dtype=torch.float32)).numpy()
            yield scene, i, cam, Tcw, render_frame(cam, Tcw, landmarks, intensities,
                                                   patches=patches)


def synthetic_descriptors(n_scenes: int, frames_per_scene: int, n_features: int, seed: int,
                          device: torch.device | str, log=print) -> list:
    """Each frame's descriptors ([n, 8] uint32) of the synthetic sweep."""
    out = []
    for scene, i, cam, _, img in synthetic_images(n_scenes, frames_per_scene, seed):
        out.append(extract(img, cam, n_features, device))
        if i + 1 == frames_per_scene:
            log(f"scene {scene + 1}/{n_scenes}: {sum(len(d) for d in out)} descriptors")
    return out


def dataset_descriptors(dataset: str, max_frames: int, n_features: int,
                        device: torch.device | str, log=print) -> list:
    """Each frame's descriptors from a directory of images (TUM rgb/,
    KITTI image_0/, or any flat image folder), at most max_frames
    frames evenly strided."""
    import cv2

    files: list[str] = []
    for pat in ("*.png", "*.jpg", "*.jpeg"):
        files += glob.glob(os.path.join(dataset, pat))
        files += glob.glob(os.path.join(dataset, "*", pat))
    files = sorted(files)
    if not files:
        raise FileNotFoundError(f"no images under {dataset}")
    stride = max(len(files) // max_frames, 1)
    files = files[::stride][:max_frames]
    out = []
    cam = None
    for i, path in enumerate(files):
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            continue
        if cam is None or cam.width != img.shape[1]:
            cam = default_camera(img.shape[1], img.shape[0])
        out.append(extract(img.astype(np.float32), cam, n_features, device))
        if (i + 1) % 20 == 0:
            log(f"{i + 1}/{len(files)} frames")
    return out


def distinct_words(voc: Vocabulary, desc: np.ndarray, device: torch.device | str) -> int:
    """How many distinct words the descriptors hit (the training set's
    re-transform check)."""
    d = torch.from_numpy(np.ascontiguousarray(desc).view(np.int32)).to(device)
    words, _ = transform(voc, d, torch.ones(len(desc), dtype=torch.bool, device=d.device))
    words = words.cpu().numpy()
    return len(np.unique(words[words >= 0]))


def train(desc: np.ndarray, k: int, depth: int, seed: int, device: torch.device | str,
          log=print) -> tuple[Vocabulary, dict]:
    """The vocabulary of the training descriptors: the k-means tree on
    the host, then the idf weights on `device`. Returns it and the
    stages' seconds (host wall; the idf's end waits for the device)."""
    t0 = time.perf_counter()
    voc = build_tree(desc, k=k, depth=depth, seed=seed)
    t1 = time.perf_counter()
    voc.word_weight = idf_weights(voc, desc, device)
    t2 = time.perf_counter()
    log(f"vocabulary: {voc.n_words} words (k={voc.k}, L={voc.depth}) built in "
        f"{t2 - t0:.1f}s (k-means {t1 - t0:.1f}s, idf {t2 - t1:.1f}s)")
    return voc, {"kmeans_s": t1 - t0, "idf_s": t2 - t1}


def add_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--out", default=None,
                   help="the npz to write (default runs/vocab/vocab_k<K>_L<DEPTH>.npz)")
    p.add_argument("--text-out", default=None, help="also write the DBoW2 text format")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--depth", type=int, default=5)
    p.add_argument("--dataset", default=None, help="image directory (else: synthetic sweep)")
    p.add_argument("--n-scenes", type=int, default=24)
    p.add_argument("--frames-per-scene", type=int, default=8)
    p.add_argument("--max-frames", type=int, default=400)
    p.add_argument("--n-features", type=int, default=1200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the extraction and the idf pass (default cuda, "
                        "which raises without a card; cpu runs on the CPU)")
    return p


def default_out(k: int, depth: int) -> str:
    return os.path.join("runs", "vocab", f"vocab_k{k}_L{depth}.npz")


def run(args, log=print) -> dict:
    """The tool: descriptors, training, the re-transform check of the
    first 20,000 training descriptors, the files. Returns the summary:
    the vocabulary, each frame's descriptors, the count of distinct
    words hit, the paths written and each stage's seconds (host wall)."""
    device = torch_device(args.device)
    out_path = args.out or default_out(args.k, args.depth)
    t0 = time.perf_counter()
    if args.dataset:
        frames = dataset_descriptors(args.dataset, args.max_frames, args.n_features, device,
                                     log)
    else:
        frames = synthetic_descriptors(args.n_scenes, args.frames_per_scene, args.n_features,
                                       args.seed, device, log)
    desc = np.concatenate(frames, axis=0)
    extract_s = time.perf_counter() - t0
    log(f"{len(desc)} training descriptors ({extract_s:.1f}s)")
    voc, stages = train(desc, args.k, args.depth, args.seed, device, log)
    uniq = distinct_words(voc, desc[:20000], device)
    log(f"{min(len(desc), 20000)} training descriptors hit {uniq} distinct words")

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    save_vocabulary_npz(voc, out_path)
    log(f"saved {out_path} ({os.path.getsize(out_path) / 1e6:.1f} MB)")
    if args.text_out:
        save_text_vocabulary(voc, args.text_out)
        log(f"saved {args.text_out} (DBoW2 text format)")
    return {"vocabulary": voc, "frames": frames, "n_descriptors": len(desc),
            "distinct_words": uniq, "out": out_path, "text_out": args.text_out,
            "extract_s": extract_s, **stages}


def main(args) -> int:
    run(args)
    return 0
