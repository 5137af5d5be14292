"""KeyFrameDatabase: BoW inverted index for place recognition.

A copy of orb_slam2_test_tpu/slam_map/keyframe_db.py (numpy only), kept
in the port so that it needs nothing of the JAX package. Replaces
src/KeyFrameDatabase.cc. The index itself is host-side (it is
a mutation-heavy sparse structure queried a few times per keyframe —
exactly the access pattern the reference serves with std::list under a
mutex; there is no batched compute to put on the device). The heavy part —
descriptor->word transform — runs on the device in bow/vocabulary.py.

Scoring follows DBoW2's L1 metric on tf-idf-normalized BoW vectors:
    s(v, w) = 1 - 0.5 * |v/|v| - w/|w||_1
Candidate selection mirrors DetectLoopCandidates /
DetectRelocalizationCandidates: shared-word prefilter (>= 0.8 * max
common words), min-score gate, covisibility-group score accumulation,
and the 0.75 * best-accumulated-score cut.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def bow_vector(word_ids: np.ndarray, weights: np.ndarray) -> dict[int, float]:
    """tf-idf, L1-normalized sparse BoW vector from per-feature words."""
    v: dict[int, float] = defaultdict(float)
    for w in word_ids:
        if w >= 0:
            v[int(w)] += float(weights[int(w)])
    norm = sum(abs(x) for x in v.values())
    if norm > 0:
        for k in v:
            v[k] /= norm
    return dict(v)


def l1_score(v1: dict[int, float], v2: dict[int, float]) -> float:
    """DBoW2 L1Scoring: 1 - 0.5 * |v1 - v2|_1 for L1-normalized vecs;
    computed over the union via the shared-word identity."""
    s = 0.0
    for w, x in v1.items():
        y = v2.get(w)
        if y is not None:
            s += abs(x) + abs(y) - abs(x - y)
    return 0.5 * s


class KeyFrameDatabase:
    def __init__(self, word_weights: np.ndarray):
        self.word_weights = np.asarray(word_weights, np.float32)
        self.inverted: dict[int, set[int]] = defaultdict(set)
        self.bow: dict[int, dict[int, float]] = {}
        self.words: dict[int, np.ndarray] = {}

    def add(self, kf_id: int, word_ids: np.ndarray) -> None:
        word_ids = np.asarray(word_ids)
        self.words[kf_id] = word_ids
        self.bow[kf_id] = bow_vector(word_ids, self.word_weights)
        for w in set(int(x) for x in word_ids if x >= 0):
            self.inverted[w].add(kf_id)

    def erase(self, kf_id: int) -> None:
        if kf_id not in self.words:
            return
        for w in set(int(x) for x in self.words[kf_id] if x >= 0):
            self.inverted[w].discard(kf_id)
        del self.words[kf_id]
        del self.bow[kf_id]

    def score(self, id1: int, id2: int) -> float:
        return l1_score(self.bow[id1], self.bow[id2])

    def _shared_word_counts(
        self, word_ids: np.ndarray, exclude: set[int]
    ) -> dict[int, int]:
        counts: dict[int, int] = defaultdict(int)
        for w in set(int(x) for x in word_ids if x >= 0):
            for kf in self.inverted.get(w, ()):
                if kf not in exclude:
                    counts[kf] += 1
        return counts

    def query_loop_candidates(
        self,
        qv: dict[int, float],
        word_ids: np.ndarray,
        exclude: set[int],
        min_score: float,
    ) -> list[tuple[int, float]]:
        """Stage 1 of DetectLoopCandidates: shared-word prefilter
        (> 0.8 * max common words) + L1 min-score gate against a query
        BoW vector. O(shared-words + candidates) — no covisibility
        needed, so the caller can compute groups for the few survivors
        only (the round-1 version built groups for EVERY database
        keyframe per query: quadratic at map scale)."""
        counts = self._shared_word_counts(np.asarray(word_ids), exclude)
        if not counts:
            return []
        max_common = max(counts.values())
        min_common = 0.8 * max_common
        scored = []
        for kf, c in counts.items():
            if c > min_common:
                s = l1_score(qv, self.bow[kf])
                if s >= min_score:
                    scored.append((kf, s))
        return scored

    @staticmethod
    def accumulate_groups(
        scored: list[tuple[int, float]],
        covis_groups: dict[int, set[int]],
    ) -> list[int]:
        """Stage 2: covisibility-group score accumulation + the
        0.75 * best-accumulated cut (reference DetectLoopCandidates
        second half). O(candidates * group size)."""
        if not scored:
            return []
        score_of = dict(scored)
        acc = []
        for kf, s in scored:
            group = covis_groups.get(kf, {kf})
            tot, best_kf, best_s = s, kf, s
            for kf2 in group:
                if kf2 == kf:
                    continue
                s2 = score_of.get(kf2)
                if s2 is not None:
                    tot += s2
                    if s2 > best_s:
                        best_kf, best_s = kf2, s2
            acc.append((best_kf, tot))
        best_acc = max(t for _, t in acc)
        th = 0.75 * best_acc
        out, seen = [], set()
        for kf, t in acc:
            if t > th and kf not in seen:
                seen.add(kf)
                out.append(kf)
        return out

    def detect_loop_candidates(
        self,
        kf_id: int,
        min_score: float,
        connected: set[int],
        covis_groups: dict[int, set[int]],
    ) -> list[int]:
        """DetectLoopCandidates: exclude the query's covisible group,
        shared-words prefilter, min_score gate, covisibility-group
        accumulation, 0.75 * best cut. `covis_groups[k]` = covisible
        neighborhood of candidate k (for group accumulation)."""
        exclude = set(connected) | {kf_id}
        scored = self.query_loop_candidates(
            self.bow[kf_id], self.words[kf_id], exclude, min_score
        )
        return self.accumulate_groups(scored, covis_groups)

    def detect_reloc_candidates(self, word_ids: np.ndarray) -> list[int]:
        """DetectRelocalizationCandidates (no min-score gate; groups
        approximated by individual keyframes)."""
        counts = self._shared_word_counts(np.asarray(word_ids), set())
        if not counts:
            return []
        max_common = max(counts.values())
        min_common = 0.8 * max_common
        qv = bow_vector(np.asarray(word_ids), self.word_weights)
        scored = [
            (kf, l1_score(qv, self.bow[kf]))
            for kf, c in counts.items()
            if c > min_common
        ]
        if not scored:
            return []
        best = max(s for _, s in scored)
        return [kf for kf, s in sorted(scored, key=lambda x: -x[1])
                if s > 0.75 * best]
