"""Loop closing, the database half: place recognition per keyframe.

Port of the detection side of orb_slam2_test_tpu/engine/loop_closing.py
(reference: src/LoopClosing.cc DetectLoop). Each resolved keyframe is
transformed to BoW words on the device (bow/vocabulary.py), read back
with its covisibility row in one copy, checked for loop candidates in
the keyframe database (slam_map/keyframe_db.py) with the
covisibility-consistency chain (>= 3 consecutive detections), and added
to the database. The database also serves relocalization's candidate
query (Tracking::Relocalization).

Not ported yet: ComputeSim3 and CorrectLoop (`_compute_and_correct`:
SearchByBoW, Sim3 RANSAC, SearchBySim3, the essential graph and the
global BA), so a detected loop is recorded and not closed.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam2_test_tpu_torch.bow.vocabulary import Vocabulary, transform
from orb_slam2_test_tpu_torch.engine.frame import FrameData
from orb_slam2_test_tpu_torch.slam_map.covisibility import COVIS_THRESHOLD, covisibility_weights
from orb_slam2_test_tpu_torch.slam_map.keyframe_db import KeyFrameDatabase, bow_vector, l1_score
from orb_slam2_test_tpu_torch.slam_map.mapstate import MapState

# reference constants
MIN_KF_GAP = 10  # KFs since last loop before detecting again
CONSISTENCY_TH = 3
# the Sim3 stage's gates (the loop-correction slice)
MIN_SIM3_MATCHES = 20
MIN_SIM3_INLIERS = 20
MIN_TOTAL_MATCHES = 40  # reference ComputeSim3 final acceptance gate


def _kf_as_frame(m: MapState, kf: int) -> FrameData:
    """A keyframe's features as a FrameData (SearchByBoW / SearchBySim3
    match keyframe against keyframe)."""
    return FrameData(
        uv=m.kf_uv[kf],
        uv_raw=m.kf_uv[kf],
        level=m.kf_level[kf],
        angle=m.kf_angle[kf],
        desc=m.kf_desc[kf],
        valid=m.kf_kp_valid[kf],
        ur=m.kf_ur[kf],
        depth=m.kf_depth[kf],
        timestamp=m.kf_timestamp[kf],
    )


class LoopCloser:
    def __init__(
        self,
        cam,
        voc: Vocabulary,
        fix_scale: bool = False,
        seed: int = 7,
        min_kf_gap: int = MIN_KF_GAP,
        device: torch.device | str = "cuda",
    ):
        self.cam = cam
        self.voc = voc
        voc.on(device)  # the vocabulary's arrays go to the device once, here
        self.db = KeyFrameDatabase(voc.word_weight)
        self.fix_scale = fix_scale
        # Sim3 RANSAC draws of the loop-correction stage
        self.generator = torch.Generator().manual_seed(seed)
        self.consistent_groups: list[tuple[set, int]] = []
        self.last_loop_kf = -1
        self.min_kf_gap = min_kf_gap
        self.n_loops_closed = 0
        self.last_candidate = None  # the last keyframe's detected loop candidate

    # ------------------------------------------------------------------
    def kf_words(self, m: MapState, kf: int) -> np.ndarray:
        w, _ = transform(self.voc, m.kf_desc[kf], m.kf_kp_valid[kf])
        return w.cpu().numpy()

    def on_new_keyframe(self, m: MapState, kf_id: int):
        """Returns (map, loop_closed: bool). Adds the keyframe to the
        database either way (reference DetectLoop adds at the end)."""
        # one copy to the host for the keyframe's words and covisibility
        # row (the JAX package's one device_get)
        w_dev, _ = transform(self.voc, m.kf_desc[kf_id], m.kf_kp_valid[kf_id])
        q = torch.tensor([kf_id], device=w_dev.device)
        covw_dev = covisibility_weights(m, q)[0]
        host = torch.cat([w_dev, covw_dev]).cpu().numpy()
        words, covw = host[: w_dev.shape[0]], host[w_dev.shape[0]:]
        connected = set(np.nonzero(covw >= COVIS_THRESHOLD)[0].tolist())

        loop_closed = False
        candidate = None
        if len(self.db.words) >= 3 and kf_id - self.last_loop_kf > self.min_kf_gap:
            candidate = self._detect_loop(m, kf_id, words, connected)
        self.last_candidate = candidate
        if candidate is not None:
            ok, m = self._compute_and_correct(m, kf_id, candidate)
            loop_closed = ok
            if ok:
                self.last_loop_kf = kf_id
                self.n_loops_closed += 1

        self.db.add(kf_id, words)
        return m, loop_closed

    def rebuild_from_map(self, m: MapState) -> None:
        """Recompute the keyframe database from a (restored) map: BoW
        word lists are derivable state, so checkpoints do not store them
        (io/checkpoint.py load_tracker)."""
        self.db = KeyFrameDatabase(self.voc.word_weight)
        self.consistent_groups = []
        for kf in np.nonzero(m.kf_valid.cpu().numpy())[0]:
            self.db.add(int(kf), self.kf_words(m, int(kf)))

    # ------------------------------------------------------------------
    def _detect_loop(self, m, kf_id, words, connected):
        # min reference score vs covisible keyframes (reference: minScore)
        qv = bow_vector(words, self.db.word_weights)
        qv_scores = [l1_score(qv, self.db.bow[c]) for c in connected if c in self.db.bow]
        min_score = min(qv_scores) if qv_scores else 0.3

        # stage 1: inverted-index prefilter + score gate
        scored = self.db.query_loop_candidates(qv, words, set(connected) | {kf_id}, min_score)
        if not scored:
            # reference DetectLoop: no candidates -> clear the
            # consistency chains (stale groups would chain a later
            # unrelated candidate)
            self.consistent_groups = []
            return None

        # stage 2: covisibility groups for the few scored candidates only
        cand_ids = [kf for kf, _ in scored]
        W = covisibility_weights(
            m, torch.tensor(cand_ids, device=m.kf_valid.device)).cpu().numpy()
        covis_groups = {
            k: set(np.nonzero(W[row] >= COVIS_THRESHOLD)[0].tolist()) | {k}
            for row, k in enumerate(cand_ids)
        }
        cands = self.db.accumulate_groups(scored, covis_groups)

        # covisibility-consistency chaining (reference: the candidate's
        # group must intersect a group seen in >= 3 consecutive
        # detections)
        new_groups: list[tuple[set, int]] = []
        enough: list[int] = []
        for cand in cands:
            group = covis_groups.get(cand, {cand})
            count = 0
            for prev_group, prev_count in self.consistent_groups:
                if group & prev_group:
                    count = max(count, prev_count + 1)
            new_groups.append((group, count))
            if count >= CONSISTENCY_TH - 1:
                enough.append(cand)
        self.consistent_groups = new_groups
        return enough[0] if enough else None

    # ------------------------------------------------------------------
    def _compute_and_correct(self, m: MapState, kf_id: int, cand: int):
        """ComputeSim3 + CorrectLoop. They need Sim3, search_by_bow,
        search_by_sim3 and the pose graph, which come with the
        loop-correction slice of the port; until then a detected loop is
        not closed and the map is returned unchanged."""
        return False, m
