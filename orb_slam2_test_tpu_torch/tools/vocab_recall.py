"""Place-recognition recall of a vocabulary on a revisit sequence.

The counterpart of the JAX package's examples/vocab_recall.py. On a
loop dataset (e.g. `make_synth_data kitti`): frames [0, split) become a
pseudo-keyframe database, frames [split, end), the loop's revisit,
query it. A query is a top-5 HIT when one of its first five candidates
lies within --radius metres of the query's true camera centre, a top-1
hit when the first does (`true_centers`: where the JAX script's
positions are not the centres). Reports top-1 / top-5 recall per
vocabulary, in the JAX script's JSON fields.

  python -m orb_slam2_test_tpu_torch.cli vocab_recall DATASET \\
      --vocab orb_slam2_test_tpu/data/vocab_k10_L5.npz \\
      --vocab orb_slam2_test_tpu/data/vocab_k10_L6.npz \\
      --split 500 --stride 2 --out runs/vocab_recall_torch.json

The extraction (kernel 1: one launch per frame) and each vocabulary's
`transform` run on --device; the database and its scoring are host code
(`slam_map/keyframe_db.KeyFrameDatabase`).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from orb_slam2_test_tpu_torch.bow.vocabulary import Vocabulary, load_vocabulary, transform
from orb_slam2_test_tpu_torch.engine.frame import build_frame_mono
from orb_slam2_test_tpu_torch.io.datasets import Sequence, load_kitti
from orb_slam2_test_tpu_torch.io.settings import load_settings
from orb_slam2_test_tpu_torch.io.trajectory import load_trajectory_tum
from orb_slam2_test_tpu_torch.slam_map.keyframe_db import KeyFrameDatabase
from orb_slam2_test_tpu_torch.tools import torch_device


def true_centers(dataset: str, seq: Sequence, idx: list) -> dict:
    """{i: the true camera centre [3] of frame i}: the translation of the
    dataset's groundtruth.txt pose (camera to world), matched by
    timestamp (to 1e-4 s). The JAX script takes -R^T t of that pose,
    which is Tcw's translation, not the centre: on a circular drive it is
    the same point for every frame (within the path's 0.3 m wobble), so
    every candidate lies within --radius and its recall counts the
    queries that have a candidate at all."""
    centers = {}
    for ts, T in load_trajectory_tum(os.path.join(dataset, "groundtruth.txt")):
        centers[round(float(ts), 4)] = T[:3, 3]
    return {i: centers[round(float(seq.items[i].timestamp), 4)] for i in idx}


def extract_sequence(dataset: str, stride: int, n_features: int,
                     device: torch.device | str, log=print) -> tuple[list, dict, dict]:
    """Every `stride`-th left frame of a KITTI-format dataset (with its
    settings.yaml and groundtruth.txt) through `build_frame_mono` on
    `device`. Returns (frame indices, {i: [n, 8] int32 descriptors of the
    valid features}, `true_centers`)."""
    cam = load_settings(os.path.join(dataset, "settings.yaml")).camera
    seq = load_kitti(dataset, stereo=False)
    idx_all = list(range(0, len(seq), stride))
    descs = {}
    for j, i in enumerate(idx_all):
        ts, img = seq.load(seq.items[i])
        f = build_frame_mono(torch.from_numpy(img).to(device), ts, cam, n_features=n_features)
        descs[i] = f.desc.cpu().numpy()[f.valid.cpu().numpy()]
        if (j + 1) % 50 == 0:
            log(f"  extracted {j + 1}/{len(idx_all)}")
    return idx_all, descs, true_centers(dataset, seq, idx_all)


def recall(descs: dict, centers: dict, vocab: Vocabulary, db_idx: list, q_idx: list,
           radius: float, device: torch.device | str = "cuda") -> dict:
    """Top-1 / top-5 recall of `vocab`: the database frames' words (each
    frame's descriptors through `transform` on `device`) go into a
    KeyFrameDatabase, and each query's relocalization candidates, best
    first, count as hits within `radius` metres of its centre."""
    db = KeyFrameDatabase(vocab.word_weight)
    words = {}
    for i in list(db_idx) + list(q_idx):
        d = torch.from_numpy(np.ascontiguousarray(descs[i]).view(np.int32)).to(device)
        w, _ = transform(vocab, d, torch.ones(len(d), dtype=torch.bool, device=d.device))
        words[i] = w.cpu().numpy()
    for i in db_idx:
        db.add(i, words[i])
    top1 = top5 = 0
    for q in q_idx:
        cands = db.detect_reloc_candidates(words[q])[:5]
        good = [c for c in cands if np.linalg.norm(centers[c] - centers[q]) <= radius]
        if cands and cands[0] in good:
            top1 += 1
        if good:
            top5 += 1
    n = max(len(q_idx), 1)
    return {"n_words": int(vocab.n_words), "top1_recall": round(top1 / n, 4),
            "top5_recall": round(top5 / n, 4)}


def reachable(centers: dict, db_idx: list, q_idx: list, radius: float) -> int:
    """How many queries have a database frame within `radius`: the most
    hits any vocabulary can score."""
    if not db_idx:
        return 0
    db = np.stack([centers[i] for i in db_idx])
    return sum(bool((np.linalg.norm(db - centers[q], axis=1) <= radius).any())
               for q in q_idx)


def report(dataset: str, idx_all: list, descs: dict, centers: dict, vocab_paths: list,
           split: int, radius: float, device: torch.device | str, log=print) -> dict:
    """The JAX script's report: the split, the database and query counts
    and each vocabulary's `recall`, keyed by its file name. Logs how many
    queries can be hits at all (`reachable`)."""
    db_idx = [i for i in idx_all if i < split]
    q_idx = [i for i in idx_all if i >= split]
    out = {"dataset": dataset, "split": split, "radius_m": radius, "n_db": len(db_idx),
           "n_queries": len(q_idx), "vocabs": {}}
    log(f"{reachable(centers, db_idx, q_idx, radius)} of {len(q_idx)} queries have a "
        f"database frame within {radius} m")
    for path in vocab_paths:
        r = recall(descs, centers, load_vocabulary(path), db_idx, q_idx, radius, device)
        out["vocabs"][os.path.basename(path)] = r
        log(f"{path}: {r}")
    return out


def add_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("dataset", help="KITTI-format sequence dir with settings.yaml and "
                                   "groundtruth.txt")
    p.add_argument("--vocab", action="append", required=True)
    p.add_argument("--split", type=int, default=500)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--radius", type=float, default=8.0)
    p.add_argument("--n-features", type=int, default=2000)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the extraction and the transforms (default cuda, "
                        "which raises without a card; cpu runs on the CPU)")
    return p


def main(args) -> int:
    device = torch_device(args.device)
    idx_all, descs, pos = extract_sequence(args.dataset, args.stride, args.n_features, device)
    n_db = sum(i < args.split for i in idx_all)
    print(f"{n_db} database frames, {len(idx_all) - n_db} queries")
    rep = report(args.dataset, idx_all, descs, pos, args.vocab, args.split, args.radius,
                 device)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)
        print(f"written to {args.out}")
    return 0
