"""Loop closing: detect -> Sim3 -> correct -> essential graph -> global BA.

Port of orb_slam2_test_tpu/engine/loop_closing.py (reference:
src/LoopClosing.cc). Per resolved keyframe (the reference runs a third
thread; here the Tracker calls it at each backend flush):

  DetectLoop    -> BoW candidates from the keyframe database
                   (slam_map/keyframe_db.py) and the
                   covisibility-consistency chain (>= 3 consecutive
                   detections).
  ComputeSim3   -> SearchByBoW between the keyframe and the candidate's
                   points, Sim3 RANSAC (solvers/sim3_solver.py, samples
                   drawn on the host from the closer's generator),
                   SearchBySim3, Gauss-Newton refinement, and the final
                   projection gate over the loop neighbourhood.
  CorrectLoop   -> `_correct_loop_device`, one device program with no
                   host read: the Sim3 propagated to the covisible
                   group, its points moved, the loop-side points fused
                   into the group, the essential graph assembled and
                   optimized (solvers/pose_graph.py), every point
                   re-anchored, the loop edge recorded.
  Global BA     -> a CG bundle adjustment of the whole map
                   (solvers/ba_core.py) in resumable chunks, one per
                   flush; a new loop drops the chunks left (reference
                   RunGlobalBundleAdjustment and mbStopGBA), and the
                   result is applied to the map as it is by then.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from orb_slam2_test_tpu_torch.bow.vocabulary import Vocabulary, transform
from orb_slam2_test_tpu_torch.engine.frame import FrameData
from orb_slam2_test_tpu_torch.engine.matchers import (
    search_by_bow,
    search_by_projection,
    search_by_sim3,
)
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.geometry.se3 import se3_inverse
from orb_slam2_test_tpu_torch.geometry.sim3 import (
    se3_from_sim3,
    sim3_apply,
    sim3_from_se3,
    sim3_inverse,
)
from orb_slam2_test_tpu_torch.ops.extractor import top_k_stable
from orb_slam2_test_tpu_torch.slam_map.covisibility import (
    COVIS_THRESHOLD,
    add_loop_edge,
    covisibility_weights,
)
from orb_slam2_test_tpu_torch.slam_map.keyframe_db import KeyFrameDatabase, bow_vector, l1_score
from orb_slam2_test_tpu_torch.slam_map.mapstate import MapState
from orb_slam2_test_tpu_torch.solvers.ba_core import (
    BAProblem,
    _robust_cost,
    bundle_adjust_partial,
    chi2_active_gate,
)
from orb_slam2_test_tpu_torch.solvers.pose_graph import optimize_essential_graph
from orb_slam2_test_tpu_torch.solvers.sim3_solver import (
    optimize_sim3,
    sample_probabilities,
    sim3_ransac,
)
from orb_slam2_test_tpu_torch.utils.scatter import put_row, take

# reference constants
MIN_KF_GAP = 10  # KFs since last loop before detecting again
CONSISTENCY_TH = 3
MIN_SIM3_MATCHES = 20
MIN_SIM3_INLIERS = 20
MIN_TOTAL_MATCHES = 40  # reference ComputeSim3 final acceptance gate
COVIS_EDGE_MIN = 100  # strong-covisibility essential-graph edges
SIM3_ITERS = 128  # RANSAC hypotheses (sim3_ransac's n_iters)


def _kf_as_frame(m: MapState, kf) -> FrameData:
    """A keyframe's features as a FrameData (SearchByBoW, SearchBySim3
    and the fuse match keyframe against keyframe). `kf` is an int or a
    0-d index tensor (read with `take`, no host read)."""
    if torch.is_tensor(kf):
        def get(x):
            return take(x, kf)
    else:
        def get(x):
            return x[kf]
    uv = get(m.kf_uv)
    return FrameData(
        uv=uv,
        uv_raw=uv,
        level=get(m.kf_level),
        angle=get(m.kf_angle),
        desc=get(m.kf_desc),
        valid=get(m.kf_kp_valid),
        ur=get(m.kf_ur),
        depth=get(m.kf_depth),
        timestamp=get(m.kf_timestamp),
    )


def _apply_gba_device(
    m: MapState,
    prob: BAProblem,  # the problem after the last chunk, slot-aligned with m
    was_kf_valid: torch.Tensor,
    was_pt_valid: torch.Tensor,
    kf_frame_id0: torch.Tensor,
    pt_first0: torch.Tensor,
) -> MapState:
    """Apply a finished global BA to the CURRENT map.

    Keyframes and points that existed at the snapshot and still hold
    the same slot (the frame-id and first-keyframe stamps guard against
    a recycled slot) adopt the optimized values. Keyframes created while
    the chunks ran move with their spanning-tree parent (T_child' =
    T_child T_parent^-1 T_parent'), new points with their reference
    keyframe: the reference's propagation after
    RunGlobalBundleAdjustment."""
    covered_kf = was_kf_valid & m.kf_valid & (m.kf_frame_id == kf_frame_id0)
    par = m.kf_parent.clamp(min=0).to(torch.int64)
    par_ok = (m.kf_parent >= 0) & covered_kf[par]
    hop = m.kf_Tcw @ se3_inverse(m.kf_Tcw[par]) @ prob.cam_Tcw[par]
    new_kf = m.kf_valid & ~covered_kf & par_ok
    new_Tcw = torch.where(covered_kf[:, None, None], prob.cam_Tcw,
                          torch.where(new_kf[:, None, None], hop, m.kf_Tcw))

    covered_pt = was_pt_valid & m.pt_valid & (m.pt_first_kf == pt_first0)
    ref = m.pt_ref_kf.clamp(min=0).to(torch.int64)
    ref_ok = (m.pt_ref_kf >= 0) & covered_kf[ref]
    # X' = Twc_ref' (Tcw_ref X), per keyframe, then gathered per point
    corr = (se3_inverse(prob.cam_Tcw) @ m.kf_Tcw)[ref]
    X_hop = (corr[:, :3, :3] @ m.pt_xyz[..., None])[..., 0] + corr[:, :3, 3]
    new_pt = m.pt_valid & ~covered_pt & ref_ok
    new_xyz = torch.where(covered_pt[:, None], prob.pt_xyz,
                          torch.where(new_pt[:, None], X_hop, m.pt_xyz))
    return m._replace(kf_Tcw=new_Tcw, pt_xyz=new_xyz)


def _index_mask(n: int, idx: torch.Tensor) -> torch.Tensor:
    """[n] bool, True at idx; idx == n writes nowhere."""
    out = torch.zeros(n + 1, dtype=torch.bool, device=idx.device)
    return out.index_fill_(0, idx.reshape(-1).to(torch.int64), True)[:n]


def _loop_side_points(m: MapState, cand: torch.Tensor, covw_c: torch.Tensor) -> torch.Tensor:
    """[P] bool: the live points of the candidate and of its covisible
    keyframes (the reference's mvpLoopMapPoints)."""
    K = m.kf_valid.shape[0]
    P = m.pt_valid.shape[0]
    ar_K = torch.arange(K, device=cand.device)
    loop_side = ((covw_c >= COVIS_THRESHOLD) & m.kf_valid) | (ar_K == cand)
    rows = torch.where(loop_side[:, None] & (m.kf_pt_idx >= 0), m.kf_pt_idx, P)
    return _index_mask(P, rows) & m.pt_valid


def _correct_loop_device(
    cam: PinholeCamera,
    m: MapState,
    kf_id: torch.Tensor,
    cand: torch.Tensor,
    S12: torch.Tensor,
    fix_scale: bool,
    n_fuse: int = 16,
    covis_cap: int = 4096,
    fuse_pt_cap: int = 8192,
) -> MapState:
    """CorrectLoop as one device program (reference
    LoopClosing::CorrectLoop, without the global BA, which runs in
    chunks): the corrected Sim3 propagated to the current keyframe's
    covisible group and its points, SearchAndFuse of the loop side into
    the group, the essential graph (spanning tree, old loop edges, the
    strongest covisibility edges, the new loop edge) optimized, every
    point moved with its reference keyframe, and the loop edge recorded.
    kf_id and cand are 0-d index tensors: nothing is read back to the
    host. Returns the corrected map."""
    K = m.kf_valid.shape[0]
    P = m.pt_valid.shape[0]
    dev = m.kf_Tcw.device
    kf_id = kf_id.to(device=dev, dtype=torch.int64)
    cand = cand.to(device=dev, dtype=torch.int64)
    ar_K = torch.arange(K, device=dev)

    # ---- the corrected Sim3 of the current keyframe and its group
    Scw_corr = S12 @ sim3_from_se3(take(m.kf_Tcw, cand))
    covw = covisibility_weights(m, kf_id.reshape(1))[0]
    group_mask = ((covw >= COVIS_THRESHOLD) & m.kf_valid) | (ar_K == kf_id)
    T_cur_inv = se3_inverse(take(m.kf_Tcw, kf_id))
    S_old_all = sim3_from_se3(m.kf_Tcw)  # [K, 4, 4]
    S_corr_all = sim3_from_se3(m.kf_Tcw @ T_cur_inv) @ Scw_corr
    S_new_all = torch.where(group_mask[:, None, None], S_corr_all, S_old_all)

    # the group's points move through their reference keyframe
    ref = m.pt_ref_kf.clamp(min=0).to(torch.int64)
    pt_in_group = group_mask[ref] & m.pt_valid & (m.pt_ref_kf >= 0)
    corr = sim3_inverse(S_new_all) @ S_old_all
    X_new = sim3_apply(corr[ref], m.pt_xyz)
    m = m._replace(
        pt_xyz=torch.where(pt_in_group[:, None], X_new, m.pt_xyz),
        kf_Tcw=torch.where(group_mask[:, None, None], se3_from_sim3(S_new_all), m.kf_Tcw),
    )

    # ---- SearchAndFuse: the loop side's points into the corrected
    # group. The candidate points are compacted once (the lowest slots
    # first, as lax.top_k ranks the 0/1 mask); the fuse is sequential,
    # each keyframe reading the links the previous one wrote: the
    # current keyframe first, then the group by weight.
    covw_c = covisibility_weights(m, cand.reshape(1))[0]
    loop_pts = _loop_side_points(m, cand, covw_c)
    csc, cid = top_k_stable(loop_pts.to(torch.int32), min(fuse_pt_cap, P))
    c_ok = csc > 0
    c_ids = torch.where(c_ok, cid, -1).to(torch.int32)
    c_xyz, c_desc = m.pt_xyz[cid], m.pt_desc[cid]
    c_normal, c_mind, c_maxd = m.pt_normal[cid], m.pt_min_dist[cid], m.pt_max_dist[cid]

    gw, gids = top_k_stable(torch.where(group_mask, covw, -1), n_fuse)
    gids = torch.cat([kf_id.reshape(1), torch.where(gw >= 0, gids, -1)])
    kf_pt_idx = m.kf_pt_idx
    for g in gids:  # 0-d views of a device tensor: no host read
        gs = g.clamp(min=0)
        pmf = search_by_projection(
            cam, take(m.kf_Tcw, gs), c_xyz, c_desc, c_ok, c_normal, c_mind, c_maxd,
            c_ids, _kf_as_frame(m, gs), radius=4.0, check_view_cos=False)
        row = take(kf_pt_idx, gs)
        new_row = torch.where((g >= 0) & (pmf.feat_pt >= 0), pmf.feat_pt, row)
        kf_pt_idx = put_row(kf_pt_idx, gs, new_row)
    m = m._replace(kf_pt_idx=kf_pt_idx)

    # ---- the essential graph's edges. Spanning tree: a parent edge per
    # keyframe, a rootless one chained to the previous live keyframe
    prev_valid = torch.cummax(torch.where(m.kf_valid, ar_K, -1), 0).values
    prev_of = torch.cat([prev_valid.new_full((1,), -1), prev_valid[:-1]])
    par = m.kf_parent.to(torch.int64)
    par_ok = (par >= 0) & m.kf_valid[par.clamp(min=0)]
    tree_a = torch.where(par_ok, par, prev_of)
    tree_ok = m.kf_valid & (tree_a >= 0) & (tree_a != ar_K)
    # the old loop edges (stored both ways: kept once, a < b)
    le = m.kf_loop_edge.to(torch.int64)
    loop_ok = m.kf_valid & (le >= 0) & m.kf_valid[le.clamp(min=0)] & (ar_K < le)
    ta = torch.minimum(tree_a.clamp(min=0), ar_K)
    tb = torch.maximum(tree_a.clamp(min=0), ar_K)
    la = torch.minimum(ar_K, le.clamp(min=0))
    lb = torch.maximum(ar_K, le.clamp(min=0))
    seen = _index_mask(K * K, torch.cat([torch.where(tree_ok, ta * K + tb, K * K),
                                         torch.where(loop_ok, la * K + lb, K * K)])).view(K, K)

    # strong covisibility edges: the covis_cap heaviest (the weakest
    # dropped past capacity), ties to the lowest cell
    Wfull = covisibility_weights(m)
    iu = torch.ones((K, K), dtype=torch.bool, device=dev).triu(1)
    wmask = (iu & (Wfull >= COVIS_EDGE_MIN) & ~seen
             & m.kf_valid[:, None] & m.kf_valid[None, :])
    cw, cidx = top_k_stable(torch.where(wmask, Wfull, -1).reshape(-1), min(covis_cap, K * K))
    cov_ok = cw >= COVIS_EDGE_MIN

    # tree [K] + old loops [K] + covisibility [cap] + the new loop edge
    ei = torch.cat([tree_a, ar_K, cidx // K, cand.reshape(1)]).clamp(min=0)
    ej = torch.cat([ar_K, le, cidx % K, kf_id.reshape(1)]).clamp(min=0)
    ev = torch.cat([tree_ok, loop_ok, cov_ok, torch.ones(1, dtype=torch.bool, device=dev)])

    # measurements from the poses before the correction; the new loop
    # edge's from the Sim3-corrected ones
    S_nodes = sim3_from_se3(m.kf_Tcw)
    meas = S_old_all[ej[:-1]] @ sim3_inverse(S_old_all[ei[:-1]])
    loop_meas = take(S_nodes, kf_id) @ sim3_inverse(take(S_nodes, cand))
    meas = torch.cat([meas, loop_meas[None]])
    S_opt = optimize_essential_graph(
        S_nodes, m.kf_valid, ar_K == cand, ei, ej, meas, ev,
        torch.ones(ei.shape[0], dtype=S_nodes.dtype, device=dev), fix_scale=fix_scale)

    # SE3 back, and every point through its reference keyframe
    corr2 = sim3_inverse(S_opt) @ S_nodes
    X2 = sim3_apply(corr2[ref], m.pt_xyz)
    ok_pt = m.pt_valid & (m.pt_ref_kf >= 0)
    m = m._replace(
        pt_xyz=torch.where(ok_pt[:, None], X2, m.pt_xyz),
        kf_Tcw=torch.where(m.kf_valid[:, None, None], se3_from_sim3(S_opt), m.kf_Tcw),
    )
    return add_loop_edge(m, kf_id, cand)


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
        # the Sim3 RANSAC draws: a host generator, so that the card and
        # the CPU draw the same samples
        self.generator = torch.Generator().manual_seed(seed)
        # the draw hook: (valid [M] bool, n_iters) -> [n_iters, 3] pair
        # indices; None draws from `generator` (tests feed the JAX
        # package's `jax.random.choice` draws in here)
        self.sim3_sampler: Optional[Callable] = None
        self.consistent_groups: list[tuple[set, int]] = []
        self.last_loop_kf = -1
        self.min_kf_gap = min_kf_gap
        self.n_loops_closed = 0
        self.last_candidate = None  # the last keyframe's detected loop candidate
        # (cost before, cost after) device scalars of the last global BA
        self.last_gba_cost = None
        self._gba = None  # the pending chunked global BA (advance_global_ba)

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
    def _draw_sim3(self, valid: torch.Tensor, n_iters: int) -> torch.Tensor:
        """[n_iters, 3] pair indices drawn with replacement, uniform over
        the valid pairs (jax.random.choice with p in the JAX package):
        one small read-back of the mask, a draw from the host generator,
        one upload."""
        if self.sim3_sampler is not None:
            idx = self.sim3_sampler(valid, n_iters)
        else:
            p = sample_probabilities(valid.cpu())
            idx = torch.multinomial(p, n_iters * 3, replacement=True,
                                    generator=self.generator).view(n_iters, 3)
        return torch.as_tensor(idx, dtype=torch.int64).to(valid.device)

    def _compute_and_correct(self, m: MapState, kf_id: int, cand: int):
        """ComputeSim3, and CorrectLoop when it succeeds. Returns (map,
        closed)."""
        dev = m.kf_Tcw.device
        # ---- SearchByBoW: the keyframe's features against the
        # candidate's points, within shared vocabulary nodes
        frame = _kf_as_frame(m, kf_id)
        row_c = m.kf_pt_idx[cand]
        has_c = (row_c >= 0) & m.kf_kp_valid[cand]
        _, nodes_cur = transform(self.voc, m.kf_desc[kf_id], m.kf_kp_valid[kf_id])
        _, nodes_c = transform(self.voc, m.kf_desc[cand], has_c)
        pm = search_by_bow(
            frame, nodes_cur, m.pt_desc[row_c.clamp(min=0).long()], has_c,
            torch.where(has_c, row_c, -1), nodes_c, m.kf_angle[cand])
        # pairs: a feature with its own point and a matched candidate point
        own = m.kf_pt_idx[kf_id]
        pair_pt = pm.feat_pt
        pair_ok = (own >= 0) & (pair_pt >= 0)
        if int(pair_ok.sum()) < MIN_SIM3_MATCHES:
            return False, m

        T1 = m.kf_Tcw[kf_id]
        T2 = m.kf_Tcw[cand]

        def cam_pts(pt_ids, T):
            X = m.pt_xyz[pt_ids.clamp(min=0).long()]
            return X @ T[:3, :3].T + T[:3, 3]

        pc1 = cam_pts(own, T1)
        pc2 = cam_pts(pair_pt, T2)
        res = sim3_ransac(self.cam, pc1, pc2, pair_ok, self._draw_sim3(pair_ok, SIM3_ITERS),
                          fix_scale=self.fix_scale, min_inliers=MIN_SIM3_INLIERS)
        if not bool(res.success):
            return False, m

        # ---- SearchBySim3: widen the matches by mutual projection
        # through the RANSAC estimate
        frame_c = _kf_as_frame(m, cand)
        m12, _ = search_by_sim3(self.cam, frame, pc1, own >= 0, frame_c,
                                cam_pts(row_c, T2), has_c, res.S12)
        widened_pt = torch.where(m12 >= 0, row_c[m12.clamp(min=0).long()], -1)
        pair_pt = torch.where(pair_ok & res.inliers, pair_pt, widened_pt)
        pair_ok2 = (own >= 0) & (pair_pt >= 0)
        S12, inl, n = optimize_sim3(self.cam, res.S12, pc1, cam_pts(pair_pt, T2), pair_ok2,
                                    fix_scale=self.fix_scale)
        if int(n) < MIN_SIM3_INLIERS:
            return False, m

        # ---- the final gate: the loop neighbourhood's points projected
        # into the keyframe through the corrected pose must give enough
        # support (reference: nTotalMatches >= 40)
        Tcw_corr = se3_from_sim3(S12 @ sim3_from_se3(T2))
        c = torch.tensor(cand, device=dev)
        loop_pts = _loop_side_points(m, c, covisibility_weights(m, c.reshape(1))[0])
        P = m.pt_valid.shape[0]
        pmw = search_by_projection(
            self.cam, Tcw_corr, m.pt_xyz, m.pt_desc, loop_pts, m.pt_normal,
            m.pt_min_dist, m.pt_max_dist, torch.arange(P, dtype=torch.int32, device=dev),
            frame, radius=10.0, check_view_cos=False, max_candidates=min(P, 8192))
        total = ((pmw.feat_pt >= 0) | (inl & pair_ok2)).sum()
        if int(total) < MIN_TOTAL_MATCHES:
            return False, m
        return True, self._correct_loop(m, kf_id, cand, S12)

    def _correct_loop(self, m: MapState, kf_id: int, cand: int, S12: torch.Tensor) -> MapState:
        """Queue the device correction, then start the global BA as
        chunks. A loop closing while a global BA is pending drops its
        chunks left (mbStopGBA): the essential graph just optimized
        subsumes their correction."""
        self._gba = None
        dev = m.kf_Tcw.device
        m = _correct_loop_device(self.cam, m, torch.tensor(kf_id, device=dev),
                                 torch.tensor(cand, device=dev), S12, self.fix_scale)
        self._start_global_ba(m)
        return m

    # ------------------------------------------------------------------
    # The global BA in abortable chunks: 4 robust LM iterations, the chi2
    # gate, 8 on the inliers, GBA_CHUNK per backend flush.
    # ------------------------------------------------------------------
    GBA_ITERS = 12
    GBA_CHUNK = 4
    GBA_ROBUST = 4

    @staticmethod
    def _build_gba_prob(m: MapState) -> BAProblem:
        """The whole map as one problem: a camera per keyframe slot, a
        point per point slot, an observation per feature slot (the
        unlinked ones invalid); keyframe 0 and dead slots fixed."""
        K, N = m.kf_pt_idx.shape
        ar_K = torch.arange(K, device=m.kf_Tcw.device)
        uvr = torch.cat([m.kf_uv, m.kf_ur[..., None]], dim=-1)
        obs_ok = (m.kf_pt_idx >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
        level_sigma2 = 1.2 ** (2.0 * m.kf_level.to(torch.float32))
        return BAProblem(
            cam_Tcw=m.kf_Tcw,
            cam_fixed=(ar_K == 0) | ~m.kf_valid,
            pt_xyz=m.pt_xyz,
            pt_valid=m.pt_valid,
            obs_cam=ar_K[:, None].expand(K, N).reshape(-1),
            obs_pt=m.kf_pt_idx.clamp(min=0).to(torch.int64).reshape(-1),
            obs_uvr=uvr.reshape(-1, 3),
            obs_isig2=(1.0 / level_sigma2).reshape(-1),
            obs_valid=obs_ok.reshape(-1),
        )

    def _start_global_ba(self, m: MapState) -> None:
        """Snapshot the map into a BAProblem and queue its chunks."""
        prob = self._build_gba_prob(m)
        cost0 = _robust_cost(prob, self.cam)  # the JAX package's _gba_cost_device
        self._gba = {
            "prob": prob,
            "lam": torch.full((), 1e-4, dtype=torch.float32, device=cost0.device),
            "cost": cost0,
            "active": torch.ones_like(prob.obs_valid),
            "robust_left": self.GBA_ROBUST,
            "inlier_left": self.GBA_ITERS - self.GBA_ROBUST,
            # the snapshot's identity: a slot recycled while the chunks
            # run must not adopt the stale result
            "kf_frame_id0": m.kf_frame_id,
            "pt_first0": m.pt_first_kf,
            "was_kf_valid": m.kf_valid,
            "was_pt_valid": m.pt_valid,
            "cost_before": cost0,
        }

    def gba_running(self) -> bool:
        return self._gba is not None

    def grow_pending(self, K: int, P: int) -> None:
        """Pad a pending global BA to a map grown to K keyframe and P
        point slots. Slots keep their positions, so the observations stay
        as they are; the new slots are fixed, invalid cameras and
        points that no observation touches, and their stamps can match
        no live slot (the JAX package leaves the problem at the old
        shapes, and its apply then fails on them)."""
        g = self._gba
        if g is None:
            return
        prob = g["prob"]
        K0, P0 = prob.cam_Tcw.shape[0], prob.pt_xyz.shape[0]
        if (K0, P0) == (K, P):
            return

        def pad(x, n, fill):
            out = x.new_full((n,) + tuple(x.shape[1:]), fill)
            out[: x.shape[0]] = x
            return out

        eye = torch.eye(4, dtype=prob.cam_Tcw.dtype, device=prob.cam_Tcw.device)
        cam_Tcw = torch.cat([prob.cam_Tcw, eye.expand(K - K0, 4, 4)])
        g["prob"] = prob._replace(
            cam_Tcw=cam_Tcw, cam_fixed=pad(prob.cam_fixed, K, True),
            pt_xyz=pad(prob.pt_xyz, P, 0.0), pt_valid=pad(prob.pt_valid, P, False))
        g.update(kf_frame_id0=pad(g["kf_frame_id0"], K, -1),
                 was_kf_valid=pad(g["was_kf_valid"], K, False),
                 pt_first0=pad(g["pt_first0"], P, -1),
                 was_pt_valid=pad(g["was_pt_valid"], P, False))

    def advance_global_ba(self, m: MapState):
        """Run one chunk of the pending global BA. Returns (map, done).
        After the last chunk the result is applied to the current map
        (`_apply_gba_device`)."""
        g = self._gba
        if g is None:
            return m, True
        if g["robust_left"] > 0:
            n = min(self.GBA_CHUNK, g["robust_left"])
            prob, lam, cost = bundle_adjust_partial(
                g["prob"], self.cam, g["lam"], g["cost"], g["active"], iters=n, robust=True)
            g.update(prob=prob, lam=lam, cost=cost)
            g["robust_left"] -= n
            if g["robust_left"] == 0:
                active, cost = chi2_active_gate(prob, self.cam)
                g.update(active=active, cost=cost)
            return m, False
        n = min(self.GBA_CHUNK, g["inlier_left"])
        prob, lam, cost = bundle_adjust_partial(
            g["prob"], self.cam, g["lam"], g["cost"], g["active"], iters=n, robust=False)
        g.update(prob=prob, lam=lam, cost=cost)
        g["inlier_left"] -= n
        if g["inlier_left"] > 0:
            return m, False
        m = _apply_gba_device(m, g["prob"], g["was_kf_valid"], g["was_pt_valid"],
                              g["kf_frame_id0"], g["pt_first0"])
        self.last_gba_cost = (g["cost_before"], g["cost"])
        self._gba = None
        return m, True
