"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's per-frame tracking through its two hand-written CUDA
kernels (kernel 1 gathers every pyramid level of an image, or both
sides of the stereo SAD, in one launch; kernel 2 is one launch per pose
optimization) and checks each kernel and each path against their plain
PyTorch versions: the mono step of slice 1 (640x480 / 1000 features /
a 2048-point local map), the whole per-frame program
(`entry.track_frame_step`: stereo frame build, motion-model tracking,
local-map tracking, keyframe-decision counts) and the keyframe
insertion (`entry.grow_map_step`) at the KITTI configuration, 1241x376
/ 2000 features / a map of 384 keyframes and 131072 points, 200 and
110000 of them live. Phases, each of which raises on a failed check:

1. build both kernels from orb_slam2_test_tpu_torch/csrc (nvcc, sm_90a);
2. patch_gather vs its plain version on all 8 pyramid levels of a
   640x480 frame, in one launch and level by level: bit-exact;
3. pose_opt vs its plain version at 1000 observations: pose atol 1e-4,
   inlier agreement > 0.99, chi2 rtol 1e-3, n_inliers = its inlier count;
4. the tracking step on a scene its frame observes: 1 patch_gather
   launch and 1 pose_opt launch, translation error < 1 cm, inliers
   >= 80% of the map, the same step on the CPU within atol 1e-4 and 1%
   of the inliers, keypoints equal to the CPU's frame, and the CPU
   port's orb_from_patches on the card's own patches (the same float32
   gather of each bin's BRIEF taps): at most 3 flipped bits in a
   descriptor, each a near-tie of its taps (FLIP_TIE_RATIO), the flip
   count printed;
5. timing on the mono frame: each kernel alone (its C entry point on
   prepared buffers, 100 launches between two CUDA events after
   warm-up), per call through its wrapper, its plain version and, for
   patch_gather, the library call (as in [9]) the same way; the step
   in ms per frame (CUDA events, median of 30); orb_from_patches on
   [4]'s patches and build_frame_mono with the BRIEF tap gather and
   with the JAX package's all-bin bf16 product in its place, in
   alternating pairs (`_brief_ab`; [9] the same on the KITTI frame);
6. the main path, one KITTI stereo frame through `track_frame_step` on
   `entry.kitti_scene`: exactly 3 patch_gather (left ORB, right ORB,
   both SAD sides) and 2 pose_opt launches, the local-map pose within
   1 cm of T_true, n_inliers >= 80% of the scene's points, a stereo
   depth on >= half the valid features,
   and the same frame on the CPU within pose atol 1e-4, 1% of the
   inliers and 1% of the features in the stereo-valid set;
7. both kernels on that frame's inputs: patch_gather bit-exact on the
   SAD coordinates of both sides in one 16-image launch (border-clipped
   windows included) and on each image's keypoints, pose_opt
   on its local-map problem with stereo rows (Tcw atol 1e-4, inlier
   agreement > 0.99, chi2 rtol 1e-3);
8. one RGB-D frame through `_build_and_track_device(sensor="rgbd")` at
   640x480 / 1000 features on a seeded depth map (untimed): 1 + 2
   launches, pose within 1 cm, the same frame on the CPU within atol
   1e-4 and 1% of the inliers;
9. KITTI timing, CUDA events (median of 30 after warm-up) and host wall:
   build_frame_stereo, _track_frame_device and track_frame_step; each
   kernel on that frame's inputs alone, per call through its wrapper,
   its plain version, for patch_gather the library call (indexing into
   `unfold` views at precomputed corners, which the port never calls),
   and pose_opt alone at O = 7 (the floor of its 40 dependent
   iterations); each kernel's bound (bytes over 3.35 TB/s or FLOP over
   67 TFLOP/s fp32, whichever is larger, from this run's inputs);
10. keyframe insertion on the main path, at full capacity on
   `entry.kitti_insert_scene` (four bands at 20-48 m, views 1.07 m
   apart): track view 1 -> full insert (`grow_map_step`, rebuild) ->
   track view 2 against the grown map -> light insert. Each tracked
   frame makes exactly 3 + 2 launches and lands within 1 cm of its true
   pose; the inserts launch neither kernel; the full insert creates
   points beyond its 100 depth points (triangulation); the caller's map
   and bitmap are unchanged; n_kf counts the live keyframes and no live
   link points at a dead slot; the full insert's bitmap has the
   incidence of `build_observer_bitmap` of its map; the first insert
   runs again under torch.cuda.set_sync_debug_mode("error") (no host
   sync); the same sequence on the CPU agrees: kf ids and culled equal,
   n_pt within 1%, links >= 99% equal. Each insert runs again on the
   CPU from the card's own inputs: kf ids and culled equal, n_pt within
   0.1%, links >= 99.9% equal. The inserted keyframes lie within 1 cm
   of their true poses. The live poses agree with the CPU's within
   INSERT_POSE_ATOL: 2e-3 for the sequence, and from the same inputs
   1e-4 (full) and 2e-3 (light, whose local BA is ill-conditioned in
   float32, in the JAX package alike). The run also prints how far the
   light insert's poses spread when the tracked pose moves by 1e-6 m,
   on the card and on the CPU, and how far the card's light insert
   lands from itself when repeated;
11. insertion timing at the JAX bench's inputs (the bench map at 200 /
   110000, a frame of two random images, T = I, random links,
   frame id 99): a full and a light insert, in turns, CUDA events and
   host wall (medians of 20 after warm-up), and the amortized KITTI ms/frame,
   track_frame_step + (full + 3 light) / 4 / KF_EVERY with KF_EVERY
   read from runs/kitti00_full/summary.json (a JAX run), and again with
   the port's own cadence from [12];
12. a whole KITTI sequence through `System` on the card: 30 stereo
   frames of `entry.kitti_sequence` (the insert scene's bands, 1.07 m
   per view) from an empty map at K = 384, P = 131072, async backend:
   stereo initialization on frame 0, 0 lost frames, >= 3 keyframes
   chosen by the Tracker itself, the exported trajectory's ATE against
   the exact poses <= 0.05 m, 3 + 2 launches on every tracked frame, a
   checkpoint that loads into a fresh System with equal keyframe poses;
   the first 5 frames again on the card and on the CPU port (async
   backend off): states and keyframe ids equal, poses within 1e-3.
   Prints track_stereo per frame (median and p90, CUDA events and host
   wall), the mean per frame over the sequence with its inserts, the
   keyframes, the cadence and the launches per frame;
13. the synthetic TUM mono recipe of .claude/skills/verify/SKILL.md
   (320x240, 160 landmarks, 15 frames, its tracker overrides), built in
   memory and driven through `cli.run`: >= 4 keyframes, 0 lost, ATE <=
   0.2 m; after --load-checkpoint --localization-only the keyframe
   count stays frozen;
14. relocalization on the KITTI sequence through `entry.kitti_system`
   with the default vocabulary (k=10, L=6) and a keyframe at least every
   2 frames: frames 0-11 (> 5 keyframes), two flat grey stereo frames
   (LOST, not a reset: 2 lost frames), the images of view 6 again at a
   later timestamp (OK by BoW candidates, PnP RANSAC and motion-only BA:
   reloc >= 1, >= 2 pose_opt launches on that frame, within 5 cm of
   T_true[6]), then views 7-12 (0 further lost frames, each within 2
   cm). Prints the System's build time with the vocabulary's load and
   word count, `transform` of the revisited frame's 2000 descriptors
   (CUDA events, median of 30; words equal to the CPU's), the
   relocalizing frame's ms (CUDA events and host wall), its candidates,
   PnP rounds and hypotheses, the share of DLT hypotheses with det
   P[:, :3] < 0 (the ones the JAX package's extraction turns 180
   degrees), its launches, and the host ms of each keyframe's
   `on_new_keyframe` at a flush. `relocalize` on the card's map and that
   frame and on their CPU copies, with the same recorded samples: both
   succeed, the same candidates tried, poses within 1e-3, inliers within
   1%. A checkpoint loaded into a fresh System, its vocabulary from the
   file as the CLI's --vocabulary PATH gives it, rebuilds the database:
   every live keyframe, the running database's words;
15. loop closing: (a) the out-and-back ring of
   tests/test_loop_closing_e2e.py (320x240 RGB-D, 120 frames, its
   tracker settings, a vocabulary trained from the sequence) through the
   port's Tracker with fix_scale and min_kf_gap 5: >= 1 loop, >= 105
   tracked frames, no global BA left pending; (b) a KITTI-geometry ring
   at full width (1241x376, 2000 features, K = 384, P = 131072, the
   default vocabulary; RING_FRAMES frames of radius RING_RADIUS, the
   shortest on which a CPU rehearsal of the port closed a loop),
   rendered by a process pool and driven through `System.track_stereo`:
   >= 1 loop, 0 lost, 3 patch_gather launches on every frame and >= 2
   pose_opt launches on every tracked one, the ATE against the truth
   before the first loop and at the end, no larger at the end; each
   prints its loop flush (on CUDA events: detection, ComputeSim3,
   `_correct_loop_device`) and every global BA chunk and apply; (c) the
   first loop's captured map and Sim3 through `_correct_loop_device` and
   one global BA chunk on the card and on the CPU port: live poses
   within CORRECT_POSE_ATOL, the card's correction again from the same
   inputs equal to its first, links >= 99% equal, points within
   CORRECT_PT_ATOL on >= 99%, the chunk's poses within GBA_POSE_ATOL;
   (d) both again under torch.cuda.set_sync_debug_mode("error") (no
   host sync);
16. the distributed BA and concurrent multi-sequence mapping
   (parallel/): (a) `entry.dryrun_multichip(1)`, the distributed BA on a
   256-camera synthetic problem and a data-parallel ORB frontend: a
   finite cost, >= 1 patch_gather launch; (b) `dist_bundle_adjust` at
   the size of the JAX package's last multi-sequence joint problem
   (`synthetic_ba_problem(271, 53871, 5)`, 8 LM iterations): 1 shard, 8
   shards in one process and a 1-rank NCCL group; with deterministic
   index adds 8 shards within 5e-4 of 1 shard and NCCL equal to it,
   15 collectives per LM iteration, the card within 1e-3 of the CPU
   port, no host sync, each run's ms and ms per LM iteration on CUDA
   events, and `measure_scaling_problem` at 1, 2, 4 and 8 shards;
   (c) three KITTI stereo sequences (`entry.kitti_multi_sequence`, seeds
   0-2, MULTI_SEQ_FRAMES frames each) through their own
   `entry.kitti_system` (K = 384, P = 131072, async backend), round-robin
   through `cli.run_multi_seq` with a joint BA every MULTI_SEQ_EVERY
   frames summed and a final one (8 LM iterations, max_cams 256, one
   shard): 0 lost frames, 3 + 2 launches on every tracked frame, each
   joint BA's cost below its merged problem's cost before it (the final
   polish, which follows no tracked frame and starts converged, within
   POLISH_COST_RTOL above it), each
   sequence's ATE <= 0.05 m after the final joint BA, the final joint
   BA per sequence within BLOCK_DIAG_ATOL of that sequence's solo
   `dist_bundle_adjust` of its own `compact_problem`, and the final
   joint BA again on the CPU port from the same maps within 1e-3;
   (d) two processes on the one card joined by gloo (NCCL refuses two
   ranks on one GPU) run the final joint BA of (c) on its maps: equal to
   the 2-shard one-process run, deterministic index adds on both sides;
17. a live KITTI stereo stream: a producer thread sends the 30 frames
   of `entry.kitti_live_frames` (uint8, epoch timestamps) at their
   timestamps' 10 fps over two TCP connections (encoding 0) and ends
   both streams; two
   `io.live.SocketSource`s feed `ApproximateTimeSync(slop=0.02)` into
   `cli.run_live` on `entry.kitti_system(live_viewer_port=0)` with
   --profile and a device trace of frames 10-19, while a client thread
   fetches /state.json twice. Checks: 30 pairs sent and tracked, 0
   lost, ATE <= 0.05 m, 3 + 0 then 3 + 2 launches per frame, the
   viewer's refreshes launch neither kernel; a direct
   `System.track_stereo` run of the same frames as float32 has equal
   keyframe ids and poses within 1e-3 (both again with deterministic
   algorithms if not); the trace lists both kernels as often as the
   counters counted over frames 10-19; one frame span per frame and
   one keyframe_insert per OK frame after the first; the last served
   state.json's keyframe centres within 1 mm of the map's live
   keyframes; `fit_plane_ransac` equal on the card's tracked points and
   their numpy copy. Prints each frame's capture to pose latency (its
   paced capture instant to track_stereo's return: median, p90, the
   last frame) and how late the producer's sends fell behind their
   instants, the live track call's ms/frame (dequeue to return) and the
   direct runs' (host float32 before and after the trace; median, p90,
   mean; CUDA events and host wall), live against direct over the same
   frames before and after the trace, the upload's share, `refresh()`'s
   parts, and the trace's device busy time and idle share beside the
   spans of the same frames;
18. the offline tools (tools/, through the CLI's parser; run before 17,
   since a process that has traced the card runs slower afterwards):
   (a) `make_synth_data kitti` writes [15b]'s ring (RING_FRAMES frames,
   radius RING_RADIUS, RING_REVOLUTIONS laps, 6000 landmarks, seed 0)
   with one spawned process per core: read back through
   `io.datasets.load_kitti`, every image bit-equal to [15b]'s
   `render_loop_stereo` in memory, the ground truth within 1e-5 of its
   poses, no kernel launch; (b) `build_vocab` on a reduced sweep
   (VOCAB_SWEEP, k = 10, L = VOCAB_DEPTH): one patch_gather launch per
   frame and no pose_opt launch, frame 0 equal to the CPU port's frame in
   keypoints, the CPU port's BRIEF bits on the card's patches equal to
   the card's but near-ties (as [4]), the tree equal to the CPU
   port's from the card's descriptors; prints the extraction ms/frame
   (CUDA events), the k-means and idf seconds; (c) `vocab_recall` on
   (a)'s dataset with the packaged L6 and (b)'s tree (split
   RECALL_SPLIT, stride RECALL_STRIDE): one patch_gather launch per frame,
   the report equal to the CPU port's from the card's descriptors; prints
   the recall; (d) `ba_window_sweep` at SWEEP_WINDOWS over (a)'s first
   SWEEP_FRAMES frames (before the loop): 3 + 0 launches on the first
   frame and 3 + 2 on every other, 0 lost, 0 loops; the window-16 row's
   keyframe ids equal to `cli.run`'s on the same frames at the dataset's
   settings, its poses within SWEEP_POSE_ATOL. Each reduced size is
   printed beside its default;
19. the six dataset commands from files (run after 18 and before 17):
   (a) `make_synth_data` writes the EuRoC, KITTI, TUM mono and TUM RGB-D
   datasets of the JAX package's recorded runs, cut to their first
   DRIVER_DATA frames at the full runs' step per frame (TUM with its
   5-frame blackout moved to frame 40), in processes of their own at
   once; (b) mono_euroc, stereo_euroc (identity LEFT.* / RIGHT.* blocks
   through `StereoRectifier`), mono_kitti, stereo_kitti, mono_tum and
   rgbd_tum through `cli.main` on the card with the default vocabulary
   (tools/dataset_runs.run_driver): LOST on exactly the blank frames
   (none on EuRoC and KITTI), 1 relocalization on the frame after them
   within the ATE ceiling of the truth, the ATE finite and below
   DRIVER_ATE_M, kernel 1 launched 1 (mono, RGB-D) or 3 (stereo) times
   on every frame and kernel 2 at least twice on every tracked and
   relocalizing frame; the frames up to DRIVER_CPU_FRAMES past the
   card's initialization again on the card and on the CPU port, which
   reads the card's keypoints and BRIEF angles and descriptors
   (_OrbTape): the selection's score maps within SCORE_RTOL of the
   card's, each position that the non-maximum suppression keeps on one
   device only tying a neighbour within SCORE_RTOL on both, each level
   whose keypoints the CPU selects otherwise giving the card's from the
   CPU's scores at the card's kept positions, the CPU's patches the
   card's within PATCH_RAW_ATOL, every bit that the CPU port's
   orb_from_patches reads otherwise on the card's own patches a near-tie
   of its taps (FLIP_TIE_RATIO, as [4]), each of the card's pose
   optimizations again through the plain version on the CPU from the
   same inputs within [3]'s bounds, equal states, and poses within
   [12]'s 1e-3 or, where they lie beyond it, DRIVER_SPREAD_FACTOR times
   the CPU port's own spread between 1 thread and its default count;
   and the same frames from the card's own state: before each frame the
   card Tracker's state is copied to the CPU (`entry.tracker_to`), the
   copy tracks the frame with the card's descriptors, and after it the
   tracking state and the keyframe decision are equal; a frame on which
   no motion-model octave prediction flips (DRIVER_FLIP_POSE_ATOL's
   comment) has equal tracked counts and its pose within [12]'s 1e-3,
   with no spread, and one on which it flips names the flips and is held
   to DRIVER_FLIP_POSE_ATOL (the largest gap of each kind is printed
   beside the 5-frame trajectory gap);
   (c) a 752x480 frame with configs/EuRoC.yaml's distortion on
   the card and the CPU: keypoints equal, undistorted uv within
   UNDISTORT_ATOL_PX; (d) a pair rectified with configs/EuRoC.yaml's real
   blocks, its stereo frame on the card and on the CPU with the card's
   descriptors: keypoints equal, right u within STEREO_UR_ATOL_PX on
   STEREO_UR_SHARE of the stereo matches either device makes, the flips
   near-ties; (e) the capped mono_tum at full length (360 frames, blank
   300-304, rendered beside (a)) through `cli.main` with the JAX
   package's L5 vocabulary: LOST on exactly the blank frames, 1
   relocalization on frame 305, the launches of (b), and the ATE within
   FULL_TUM_ATE_BOUND_M; (f) the seven SVD sites of the monocular path
   (SVD_SITES: the initialization's H and F null vectors, rank-2 F, E
   and Faugeras H decompositions, the relocalization's PnP DLT and
   `_extract_rt`, the loop's Horn) on (b)'s and (e)'s own inputs,
   captured on the card, under the card's default driver, cuSOLVER's
   gesvd, the CPU's float32 SVD and as the package runs them (the
   initialization's 3x3 SVDs through `geometry.linalg.svd`, gesvd on
   the card), each site's
   output's distance from the one a float64 CPU SVD gives: the
   package's within SVD_CPU_FACTOR times the CPU's at every site; the
   driver the package's output equals, and where that is gesvd, the ms
   a call on each driver.

20. the map past 512 keyframes (run after 19 and before 17): the loop
   map of tests/test_torch_large_map.py at KITTI width (LARGE_N_KF
   keyframes of LARGE_N features) built at LARGE_OLD's capacities,
   `grow_map` to LARGE_NEW (K 1,024, P 393,216), `_correct_loop_device`
   on the grown map (the pose graph's CG branch) and one
   `bundle_adjust_partial` chunk (4 robust LM steps) from the corrected
   map, on the card twice and on the CPU port: the two card runs
   bit-equal, the growth equal to the CPU port's, the correction and the
   chunk within [15c]'s bounds of the CPU port's, neither kernel
   launched; prints each stage's ms (CUDA events) beside [15b]'s
   correction and chunks at K 384 and the peak memory allocated; the
   observer bitmap rebuilt at the grown shape (`build_observer_bitmap`,
   whose `last_wins` takes an int64 [P K + 1]) twice on the card, its ms
   and the memory its peak took, equal to the CPU port's; at the
   very end (after 17: a process that has traced the card runs slower)
   the correction once more under the profiler, the card's activity
   only: its kernel launches and the device's idle share.

It imports only the port, numpy and the standard library. It needs one
CUDA card and exits non-zero, printing no result, without one. The last
line is the JSON object {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
N_TIMED = 30
N_WARMUP = 5


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def _cuda_ms(fn, n=N_TIMED, warmup=N_WARMUP) -> float:
    """Median device time of fn() in ms, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _loop_ms(fn, n=100, warmup=10) -> float:
    """Device ms per call of fn(): n calls back to back between two CUDA
    events, after warm-up. Where a call's host work outlasts its
    kernels, the events see the device wait for the host, so a call
    through a wrapper shows its host time too."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


# the card's peaks (NVIDIA's H100 SXM data sheet, at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# card-vs-CPU bounds on the live keyframe poses after each insert of
# phase 10: (the whole sequence on each device, each insert from the
# card's inputs). The light insert's local BA is ill-conditioned in
# float32, in the JAX package alike (PERF.md): a 1e-6 m change of the
# tracked pose moves its free keyframes by 2e-3 to 1.1e-2, so a change
# of the code that moves its inputs by rounding can cross its 2e-3; the
# run prints that spread beside the gap
INSERT_POSE_ATOL = {"full": (2e-3, 1e-4), "light": (2e-3, 2e-3)}

# kernel 2's FLOP per valid observation: a residual is 42 (pose
# transform 18, projection and stereo column 12, residuals and chi2
# 12); a Gauss-Newton term adds the Huber weight and Jacobian rows
# (39) and 27 weighted sums of 3 products (189): 270
POSE_FLOP_RES = 42
POSE_FLOP_GN = 270


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of bytes over
    its memory rate and FLOP over its fp32 rate, and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _gather_bytes(images, xy) -> int:
    """Kernel 1's bytes for one launch: each image and xy read once, the
    [N, 38, 38] float32 windows written once."""
    return 4 * (sum(i.numel() for i in images) + xy.numel() + xy.shape[0] * 38 * 38)


def _pose_bound(X, valid, rounds=4, iters=10) -> tuple[float, str]:
    """Kernel 2's bound on one problem: bytes of X, obs, inv_sigma2,
    valid and the pose in, the pose, inliers, chi2 and count out; FLOP
    of rounds x iters Gauss-Newton passes and rounds + 1 residual passes
    over the valid observations."""
    O = X.shape[0]
    nbytes = O * (12 + 12 + 4 + 1) + 64 + 64 + O * (1 + 4) + 4
    flops = int(valid.sum()) * (rounds * iters * POSE_FLOP_GN + (rounds + 1) * POSE_FLOP_RES)
    return _bound(nbytes, flops)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _unfold_gathers(gathers) -> list:
    """Kernel 1's library yardstick: for each image of each (images, xy,
    counts) launch, its [H-37, W-37, 38, 38] unfold view and the clipped
    window corners of its keypoints, computed beforehand; one advanced
    index per image then gathers the windows (the port never calls it)."""
    out = []
    for images, xy, counts in gathers:
        start = 0
        for img, n in zip(images, counts):
            h, w = img.shape
            seg = xy[start : start + n]
            start += n
            x0 = (seg[:, 0].round().long() - 19).clamp(0, w - 38)
            y0 = (seg[:, 1].round().long() - 19).clamp(0, h - 38)
            out.append((img.unfold(0, 38, 1).unfold(1, 38, 1), y0, x0))
    return out


def _launch_counts() -> dict:
    from orb_slam2_test_tpu_torch.ops import patches
    from orb_slam2_test_tpu_torch.solvers import pose_opt_cuda

    return {"patch_gather": patches.PATCH_GATHER.launches,
            "pose_opt": pose_opt_cuda.POSE_OPT.launches}


def _zero_launches() -> None:
    from orb_slam2_test_tpu_torch.ops import patches
    from orb_slam2_test_tpu_torch.solvers import pose_opt_cuda

    patches.PATCH_GATHER.launches = 0
    pose_opt_cuda.POSE_OPT.launches = 0


def _kitti_sequence_phase(dev, card: str) -> dict:
    """[12]: 30 KITTI stereo frames through System from an empty map, on
    the card; the first 5 again on the card and the CPU, sync backend."""
    import tempfile

    import torch

    from orb_slam2_test_tpu_torch import entry
    from orb_slam2_test_tpu_torch.utils.loop_probes import ate as traj_ate

    n_frames = 30
    seq = entry.kitti_sequence(np.random.default_rng(SEED + 4), n_frames, dev)
    system = entry.kitti_system(dev)
    tracker = system.tracker
    cfg = tracker.cfg
    print(f"[12] KITTI sequence: {n_frames} stereo frames {entry.KITTI_CAM.width}x"
          f"{entry.KITTI_CAM.height}, {cfg.n_features} features, K={cfg.max_keyframes} "
          f"P={cfg.max_points}, from an empty map, async_backend={cfg.async_backend}")
    torch.cuda.synchronize()
    states, fused, per_frame, events, wall_ms = [], [], [], [], []
    _zero_launches()
    t_seq = time.perf_counter()
    for frame in seq.frames:
        before = _launch_counts()
        fused.append(tracker._fused_applicable())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        entry.sequence_step(system, frame)
        end.record()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        after = _launch_counts()
        per_frame.append(tuple(after[k] - before[k] for k in ("patch_gather", "pose_opt")))
        states.append(system.tracking_state)
        events.append((start, end))
    system.shutdown()
    mean_ms = (time.perf_counter() - t_seq) * 1e3 / n_frames
    launches = _launch_counts()
    ev_ms = [s_.elapsed_time(e_) for s_, e_ in events]
    stats = tracker.stats
    n_kf = stats["n_kf"]
    traj = tracker.export_trajectory()
    ate = traj_ate(traj, seq.T_true)
    max_err = max(float(np.abs(T - seq.T_true[i])[:3, 3].max()) for i, (_, T) in enumerate(traj))
    kf_ids = sorted(tracker.map.kf_frame_id[tracker.map.kf_valid].tolist())

    def pct(x, q):
        return float(np.percentile(np.asarray(x), q))

    out = {
        "frames": n_frames, "keyframes": n_kf, "live_keyframes": tracker.n_live_kf,
        "keyframe_frame_ids": kf_ids, "lost_frames": stats["lost_frames"],
        "cadence_frames_per_kf": n_frames / max(n_kf, 1),
        "ate_rmse_m": ate["rmse"], "max_translation_error_m": max_err,
        "track_stereo_ms_median": pct(ev_ms, 50), "track_stereo_ms_p90": pct(ev_ms, 90),
        "track_stereo_wall_ms_median": pct(wall_ms, 50),
        "track_stereo_wall_ms_p90": pct(wall_ms, 90),
        "mean_wall_ms_per_frame_with_inserts": mean_ms,
        "launches_per_frame": [list(x) for x in per_frame], "launches": launches,
        "n_pt": int(tracker.map.n_pt),
    }
    print(f"    states {''.join(x[0] for x in states)}, {n_kf} keyframes (frame ids "
          f"{kf_ids}), {stats['lost_frames']} lost, cadence "
          f"{out['cadence_frames_per_kf']:.3f} frames per keyframe, {out['n_pt']} points; "
          f"ATE {ate['rmse']:.4e} m over {ate['n_pairs']} frames, largest translation "
          f"error {max_err:.4e} m")
    print(f"[12] track_stereo: median {out['track_stereo_ms_median']:.3f} ms, p90 "
          f"{out['track_stereo_ms_p90']:.3f} ms per frame on CUDA events; median "
          f"{out['track_stereo_wall_ms_median']:.3f} ms, p90 "
          f"{out['track_stereo_wall_ms_p90']:.3f} ms host wall; mean over the sequence "
          f"with its inserts {mean_ms:.3f} ms/frame host wall ({card})")
    print(f"    launches per frame (patch_gather, pose_opt): {per_frame}; total {launches}; "
          f"{sum(fused)} frames built and tracked in one call")
    _check(states[0] == "OK", f"stereo initialization on frame 0: {states[0]}")
    _check(stats["lost_frames"] == 0, f"{stats['lost_frames']} lost frames")
    _check(n_kf >= 3, f"{n_kf} keyframes")
    _check(ate["n_pairs"] == n_frames and ate["rmse"] <= 0.05, f"ATE {ate}")
    _check(per_frame[0] == (3, 0), f"initializing frame launches {per_frame[0]}")
    # every tracked frame, fused (build and track in one call) or not
    _check(all(pf == (3, 2) for pf in per_frame[1:]), f"tracked frames' launches {per_frame}")
    _check(sum(fused) >= n_frames // 2, f"{sum(fused)} fused frames")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "kitti.npz")
        system.save_checkpoint(path)
        again = entry.kitti_system(dev)
        again.load_checkpoint(path)
        _check(torch.equal(again.tracker.map.kf_Tcw, tracker.map.kf_Tcw),
               "checkpoint: kf_Tcw differs after load")
        _check(again.tracker.n_live_kf == tracker.n_live_kf, "checkpoint: live keyframes")
    print(f"    checkpoint saved and loaded into a fresh System: kf_Tcw equal, "
          f"{tracker.n_live_kf} live keyframes")

    # the first 5 frames on the card and on the CPU port, sync backend
    runs = {}
    for where in (dev, "cpu"):
        sub = entry.kitti_system(where, async_backend=False)
        frames = [(t, a.to(where), b.to(where)) for t, a, b in seq.frames[:5]]
        poses = [entry.sequence_step(sub, f) for f in frames]
        runs[str(where)] = (sub, poses)
    (card_sys, card_poses), (cpu_sys, cpu_poses) = runs[str(dev)], runs["cpu"]
    gap = max(float(np.abs(a - b).max()) for a, b in zip(card_poses, cpu_poses))
    ids = [sorted(x.tracker.map.kf_frame_id[x.tracker.map.kf_valid].tolist())
           for x in (card_sys, cpu_sys)]
    print(f"    first 5 frames, card vs CPU port (sync backend): states "
          f"{card_sys.tracker.stats} / {cpu_sys.tracker.stats}, keyframe ids {ids[0]} / "
          f"{ids[1]}, poses within {gap:.3e}")
    _check(card_sys.tracking_state == cpu_sys.tracking_state == "OK", "5-frame states")
    _check(card_sys.tracker.stats == cpu_sys.tracker.stats, "5-frame stats differ")
    _check(ids[0] == ids[1], f"keyframe ids {ids}")
    _check(gap <= 1e-3, f"card vs CPU poses differ by {gap}")
    out["card_vs_cpu_pose_gap_5_frames"] = gap
    return out


def _tum_mono_phase(dev, card: str) -> dict:
    """[13]: SKILL.md's synthetic TUM mono recipe through cli.run."""
    import tempfile

    from orb_slam2_test_tpu_torch import cli
    from orb_slam2_test_tpu_torch.io.datasets import MemorySequence
    from orb_slam2_test_tpu_torch.io.settings import SlamSettings
    from orb_slam2_test_tpu_torch.io.trajectory import save_trajectory_tum
    from orb_slam2_test_tpu_torch.system import System
    from orb_slam2_test_tpu_torch.utils.synthetic import default_camera, make_sequence

    n = 15
    cam = default_camera(320, 240)
    cam, poses_gt, _, images = make_sequence(
        np.random.default_rng(0), n, cam=cam, n_landmarks=160,
        step=np.array([0.12, 0.01, 0.0, 0.001, 0.003, 0.001]))
    stamps = [1000.0 + 0.1 * i for i in range(n)]
    # the recipe writes 8-bit PNGs
    frames = [(t, np.clip(im, 0, 255).astype(np.uint8)) for t, im in zip(stamps, images)]
    settings = SlamSettings(
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=320, height=240, fps=10.0,
        n_features=400, max_keyframes=32, max_points=4096, min_init_matches=40,
        min_init_triangulated=30, min_local_inliers=20, n_triangulate_neighbors=2,
        ba_fixed_cap=4, max_frames_between_kf=4)
    with tempfile.TemporaryDirectory() as d:
        gt = os.path.join(d, "groundtruth.txt")
        save_trajectory_tum(gt, list(zip(stamps, poses_gt)))

        def run(*extra):
            args = cli.common_parser("").parse_args(
                ["(in memory)", "(in memory)", "--groundtruth", gt,
                 "--traj-out", os.path.join(d, "traj.txt"),
                 "--kf-traj-out", os.path.join(d, "kf.txt"), *extra])
            return cli.run(System(settings, "monocular", device=dev),
                           MemorySequence("mono", frames), args, log=lambda *a: None)

        _zero_launches()
        first = run("--checkpoint-out", os.path.join(d, "map.npz"))
        launches = _launch_counts()
        again = run("--load-checkpoint", os.path.join(d, "map.npz"), "--localization-only")
    print(f"[13] TUM mono recipe (320x240, 160 landmarks, {n} frames) through cli.run: "
          f"{first['keyframes']} keyframes, {first['lost_frames']} lost, ATE "
          f"{first['ate_rmse']:.4f} m over {first['ate_pairs']} pairs, median "
          f"{first['median_s'] * 1e3:.3f} ms/frame host wall ({card}); launches {launches}; "
          f"after --load-checkpoint --localization-only: {again['keyframes']} keyframes, "
          f"{again['lost_frames']} lost")
    _check(first["keyframes"] >= 4 and first["lost_frames"] == 0, f"TUM mono run {first}")
    _check(np.isfinite(first["ate_rmse"]) and first["ate_rmse"] <= 0.2,
           f"TUM mono ATE {first['ate_rmse']}")
    _check(again["keyframes"] == first["keyframes"], "localization-only inserted keyframes")
    _check(launches["patch_gather"] == n and launches["pose_opt"] > 0, f"launches {launches}")
    return {"keyframes": first["keyframes"], "lost_frames": first["lost_frames"],
            "ate_rmse_m": first["ate_rmse"], "median_wall_ms": first["median_s"] * 1e3,
            "localization_only_keyframes": again["keyframes"], "launches": launches}


class _Draws:
    """PnP draws recorded on one run of `relocalize` and replayed, in the
    same order, on another: both devices solve the same samples."""

    def __init__(self, seed: int):
        import torch

        self.generator = torch.Generator().manual_seed(seed)
        self.log = []

    def record(self):
        from orb_slam2_test_tpu_torch.solvers.initializer import sample_indices
        from orb_slam2_test_tpu_torch.solvers.pnp import SAMPLE

        def draw(valid, n):
            idx = sample_indices(valid, n, SAMPLE, self.generator)
            self.log.append(idx.cpu())
            return idx
        return draw

    def replayer(self):
        it = iter(list(self.log))

        def sampler():
            def draw(valid, n):
                idx = next(it, None)
                _check(idx is not None and idx.shape[0] == n,
                       "the replay asked for more PnP rounds than the recorded run")
                return idx.to(valid.device)
            return draw
        return sampler


def _relocalization_phase(dev, card: str) -> dict:
    """[14]: the KITTI sequence through a System with the default
    vocabulary, blacked out for two frames, then a revisited view."""
    import tempfile

    import torch

    from orb_slam2_test_tpu_torch import cli, entry
    from orb_slam2_test_tpu_torch.bow.vocabulary import DEFAULT_VOCABULARY_PATH, transform
    from orb_slam2_test_tpu_torch.engine.frame import build_frame_stereo
    from orb_slam2_test_tpu_torch.engine.relocalization import relocalize
    from orb_slam2_test_tpu_torch.slam_map.mapstate import MapState, level_tables

    t_phase = time.perf_counter()
    seq = entry.kitti_sequence(np.random.default_rng(SEED + 5), 13, dev)
    t0 = time.perf_counter()
    system = entry.kitti_system(dev, vocabulary="default", max_frames_between_kf=2)
    build_s = time.perf_counter() - t0
    tracker = system.tracker
    closer = tracker.loop_closer
    voc = system.vocabulary
    cfg = tracker.cfg
    _check(closer is not None and closer.fix_scale, "no loop closer, or a free Sim3 scale")
    print(f"[14] relocalization: a System with the default vocabulary ({voc.n_words} words, "
          f"k={voc.k}, L={voc.depth}) built in {build_s:.3f} s (npz load, upload and the "
          f"tracker at K={cfg.max_keyframes} P={cfg.max_points}), max_frames_between_kf="
          f"{cfg.max_frames_between_kf}")

    # each keyframe's place-recognition step at its flush, host wall
    onk_ms = []
    on_new_keyframe = closer.on_new_keyframe

    def timed_on_new_keyframe(m, kf):
        t = time.perf_counter()
        out = on_new_keyframe(m, kf)
        onk_ms.append((time.perf_counter() - t) * 1e3)
        return out

    closer.on_new_keyframe = timed_on_new_keyframe

    grey = torch.full_like(seq.frames[0][1], 16)
    dt = seq.frames[1][0] - seq.frames[0][0]
    # frames 0-11; two grey frames; view 6 again; views 7-12 after it,
    # each a frame period later
    plan = ([(i, seq.frames[i]) for i in range(12)]
            + [(None, (12 * dt, grey, grey)), (None, (13 * dt, grey, grey))]
            + [(v, ((v + 8) * dt,) + seq.frames[v][1:]) for v in range(6, 13)])
    rows = []
    _zero_launches()
    for view, frame in plan:
        before = _launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        pose = entry.sequence_step(system, frame)
        end.record()
        end.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        after = _launch_counts()
        err = (None if pose is None or view is None
               else float(np.linalg.norm(pose[:3, 3] - seq.T_true[view][:3, 3])))
        rows.append({"view": view, "state": system.tracking_state, "err": err,
                     "ms": start.elapsed_time(end), "wall_ms": wall,
                     "launches": tuple(after[k] - before[k] for k in ("patch_gather", "pose_opt")),
                     "stats": dict(tracker.stats), "diag": dict(tracker.last_diag)})
    system.shutdown()
    launches = _launch_counts()
    closer.on_new_keyframe = on_new_keyframe

    pre, dark, reloc, after_rows = rows[:12], rows[12:14], rows[14], rows[15:]
    d = reloc["diag"]
    neg_share = d.get("reloc_negative_det", 0) / max(d.get("reloc_hypotheses", 0), 1)
    print(f"    states {''.join(r['state'][0] for r in rows)} (views "
          f"{[r['view'] for r in rows]}); {pre[-1]['stats']['n_kf']} keyframes before the "
          f"blackout, stats after it {dark[-1]['stats']}")
    print(f"[14] the relocalizing frame (view 6 again): {reloc['ms']:.3f} ms on CUDA events, "
          f"{reloc['wall_ms']:.3f} ms host wall ({card}); {d.get('reloc_candidates')} BoW "
          f"candidates, {d.get('reloc_tried')} tried, {d.get('reloc_pnp_rounds')} PnP rounds, "
          f"{d.get('reloc_hypotheses')} hypotheses, {d.get('reloc_negative_det')} of them "
          f"({neg_share:.2%}) with det P[:, :3] < 0 (the ones the JAX package's extraction "
          f"turns 180 degrees); launches (patch_gather, pose_opt) {reloc['launches']}; "
          f"translation error {reloc['err']}")
    print(f"    translation errors (m): frames 0-11 {[r['err'] for r in pre]}; views 7-12 after "
          f"the revisit {[r['err'] for r in after_rows]}, launches "
          f"{[r['launches'] for r in after_rows]}")
    _check(all(r["state"] == "OK" for r in pre), f"frames 0-11: {[r['state'] for r in pre]}")
    _check(pre[-1]["stats"]["n_kf"] > 5, f"{pre[-1]['stats']['n_kf']} keyframes before the blackout")
    _check([r["state"] for r in dark] == ["LOST", "LOST"], f"blackout: {[r['state'] for r in dark]}")
    _check(dark[-1]["stats"]["lost_frames"] == 2 and tracker.stats["n_kf"] > 5,
           f"blackout stats {dark[-1]['stats']}: lost or reset")
    _check(reloc["state"] == "OK" and reloc["stats"]["reloc"] >= 1, f"relocalization: {reloc}")
    _check(reloc["err"] < 0.05, f"relocalized {reloc['err']} m from T_true[6]")
    _check(reloc["launches"][1] >= 2, f"relocalizing frame launches {reloc['launches']}")
    _check(all(r["state"] == "OK" for r in after_rows)
           and tracker.stats["lost_frames"] == 2, f"after the revisit: {tracker.stats}")
    _check(max(r["err"] for r in after_rows) < 0.02,
           f"views 7-12 errors {[r['err'] for r in after_rows]}")

    # transform of the revisited frame's 2000 descriptors on the L6 tree
    kw = dict(n_features=cfg.n_features, n_levels=cfg.n_levels, scale_factor=cfg.scale_factor)
    _, left6, right6 = seq.frames[6]
    frame6 = build_frame_stereo(left6, right6, 0.0, entry.KITTI_CAM, **kw)
    transform_ms = _cuda_ms(lambda: transform(voc, frame6.desc, frame6.valid))
    words = transform(voc, frame6.desc, frame6.valid)[0]
    cpu6 = type(frame6)(*[x.cpu() for x in frame6])
    _check(torch.equal(words.cpu(), transform(voc, cpu6.desc, cpu6.valid)[0]),
           "transform: card and CPU words differ")
    print(f"[14] transform: {transform_ms:.4f} ms for {frame6.desc.shape[0]} descriptors on the "
          f"L{voc.depth} tree (CUDA events, median of {N_TIMED}; {card}); words equal the CPU's; "
          f"on_new_keyframe at a flush: {len(onk_ms)} keyframes, median "
          f"{statistics.median(onk_ms):.3f} ms, max {max(onk_ms):.3f} ms host wall ({card})")

    # relocalize on the card's map and frame and on their CPU copies,
    # with the same samples
    cands = closer.db.detect_reloc_candidates(words.cpu().numpy())
    m_card = tracker.map
    m_cpu = MapState(*[x.cpu() for x in m_card])
    draws = _Draws(SEED + 6)
    runs = {}
    for where, m, f, sampler in ((dev, m_card, frame6, draws.record), ("cpu", m_cpu, cpu6, None)):
        sig2 = level_tables(tracker.cap, where)[1]
        t0 = time.perf_counter()
        runs[str(where)] = relocalize(f, m, tracker.cam, cands, sampler or draws.replayer(), sig2,
                                      min_inliers=cfg.min_local_inliers) + (
            (time.perf_counter() - t0) * 1e3,)
    (ok_c, T_c, fp_c, info_c, ms_c), (ok_h, T_h, fp_h, info_h, ms_h) = runs[str(dev)], runs["cpu"]
    _check(ok_c and ok_h, f"relocalize: card {ok_c}, CPU {ok_h}")
    gap = float(np.abs(T_c - T_h).max())
    n_c, n_h = int((fp_c >= 0).sum()), int((fp_h >= 0).sum())
    print(f"    relocalize card vs CPU port (same samples, {len(cands)} candidates): card "
          f"{info_c} in {ms_c:.1f} ms, CPU {info_h} in {ms_h:.1f} ms host wall; poses within "
          f"{gap:.3e}, inliers {n_c} vs {n_h}")
    _check(info_c["tried"] == info_h["tried"], "candidates tried differ")
    _check(gap <= 1e-3, f"relocalize card vs CPU poses differ by {gap}")
    _check(abs(n_c - n_h) <= 0.01 * max(n_c, n_h), f"relocalize inliers {n_c} vs {n_h}")

    # a checkpoint loaded into a fresh System with the vocabulary rebuilds
    # the database: every live keyframe, with the running database's words
    # (the fresh System takes the vocabulary as the CLI's --vocabulary
    # PATH gives it: loaded from the file)
    args = cli.common_parser("").parse_args(
        ["(in memory)", "(in memory)", "--vocabulary", DEFAULT_VOCABULARY_PATH])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reloc.npz")
        system.save_checkpoint(path)
        again = entry.kitti_system(dev, vocabulary=args.vocabulary, max_frames_between_kf=2)
        again.load_checkpoint(path)
    db2 = again.tracker.loop_closer.db
    live = set(np.flatnonzero(tracker.map.kf_valid.cpu().numpy()).tolist())
    _check(set(db2.words) == live, f"rebuilt database ids {sorted(db2.words)} vs live {live}")
    for kf, w in closer.db.words.items():
        _check(np.array_equal(db2.words[kf], w), f"rebuilt words of keyframe {kf} differ")
    missing = sorted(live - set(closer.db.words))
    _check(again.vocabulary.n_words == voc.n_words, "--vocabulary PATH: another vocabulary")
    print(f"    checkpoint into a fresh System (vocabulary from --vocabulary "
          f"{os.path.basename(DEFAULT_VOCABULARY_PATH)}): database rebuilt with {len(db2.words)} keyframes, "
          f"words equal on the {len(closer.db.words)} the running database holds (not in it: "
          f"the initialization's {missing})")
    phase_s = time.perf_counter() - t_phase
    print(f"[14] took {phase_s:.1f} s")
    return {
        "vocabulary_words": voc.n_words, "system_build_s": build_s,
        "transform_ms_2000": transform_ms,
        "reloc_frame_ms": reloc["ms"], "reloc_frame_wall_ms": reloc["wall_ms"],
        "reloc_candidates": d.get("reloc_candidates"), "reloc_tried": d.get("reloc_tried"),
        "reloc_pnp_rounds": d.get("reloc_pnp_rounds"),
        "reloc_hypotheses": d.get("reloc_hypotheses"),
        "negative_det_share": neg_share, "reloc_error_m": reloc["err"],
        "reloc_frame_launches": list(reloc["launches"]),
        "after_errors_m": [r["err"] for r in after_rows],
        "on_new_keyframe_ms": onk_ms,
        "card_vs_cpu_pose_gap": gap, "card_vs_cpu_inliers": [n_c, n_h],
        "phase_s": phase_s, "launches": launches,
    }


# [15b]: the shortest KITTI-geometry ring on which the port closes a
# loop in a CPU rehearsal (examples' scene, 0.8 m and 2.3 degrees per
# frame; one lap is 157 frames, the rest revisits the start)
RING_FRAMES = 200
RING_RADIUS = 20.0
RING_REVOLUTIONS = 1.27
# [15c]: the card against the CPU port, the same inputs
CORRECT_POSE_ATOL = 1e-3  # _correct_loop_device: 40 LM steps, LU on each side
CORRECT_LINKS_MIN = 0.99
CORRECT_PT_ATOL = 1e-2  # points on >= 99%: they move with their keyframe
# one global BA chunk: 4 LM steps of 40 float32 CG iterations over the
# whole map's 768,000 observation slots, whose index adds run in another
# order on each device (1.69e-3 measured on the 200-frame ring)
GBA_POSE_ATOL = 5e-3


def _out_and_back_phase(dev, card: str) -> dict:
    """[15a]: the out-and-back ring of tests/test_loop_closing_e2e.py
    through the port's Tracker on the card."""
    import torch

    from orb_slam2_test_tpu_torch import entry
    from orb_slam2_test_tpu_torch.utils.loop_probes import LoopTimes
    from orb_slam2_test_tpu_torch.engine import loop_closing as lc

    t0 = time.perf_counter()
    scene = entry.out_and_back_scene(np.random.default_rng(0), device=dev)
    tracker = entry.out_and_back_tracker(scene, device=dev)
    render_s = time.perf_counter() - t0
    times = LoopTimes(tracker.loop_closer, lc)
    n = len(scene.images)
    _zero_launches()
    t0 = time.perf_counter()
    try:
        for i in range(n):
            tracker.process_image_rgbd(scene.images[i], scene.depths[i], i / 30.0)
        tracker.drain_backend()
        torch.cuda.synchronize()
    finally:
        times.restore()
    run_s = time.perf_counter() - t0
    launches = _launch_counts()
    stats = dict(tracker.stats)
    print(f"[15a] out-and-back ring (320x240 RGB-D, {n} frames, {scene.vocabulary.n_words} "
          f"words from the sequence, fix_scale, min_kf_gap 5): {len(tracker.trajectory)} "
          f"tracked, stats {stats}, loop keyframe {tracker.loop_closer.last_loop_kf}; "
          f"{run_s:.1f} s ({render_s:.1f} s to render and train the vocabulary); "
          f"launches {launches}")
    out = times.report("[15a]", card)
    _check(stats["loops"] >= 1, f"[15a] no loop closed: {stats}")
    _check(len(tracker.trajectory) >= n - 15, f"[15a] {len(tracker.trajectory)} tracked of {n}")
    _check(not tracker.loop_closer.gba_running(), "[15a] a global BA is still pending")
    out.update(frames=n, tracked=len(tracker.trajectory), loops=stats["loops"],
               keyframes=stats["n_kf"], lost_frames=stats["lost_frames"],
               loop_kf=tracker.loop_closer.last_loop_kf, run_s=run_s, launches=launches)
    return out


def _kitti_loop_phase(dev, card: str) -> dict:
    """[15b]-[15d]: a KITTI-geometry ring at full width through System,
    its loop correction and one global BA chunk against the CPU port,
    and both with no host sync."""
    import torch

    from orb_slam2_test_tpu_torch import entry
    from orb_slam2_test_tpu_torch.utils.loop_probes import LoopTimes, trajectory_on
    from orb_slam2_test_tpu_torch.utils.loop_probes import ate as traj_ate
    from orb_slam2_test_tpu_torch.engine import loop_closing as lc
    from orb_slam2_test_tpu_torch.slam_map.mapstate import MapState
    from orb_slam2_test_tpu_torch.solvers import ba_core

    workers = os.cpu_count() or 1
    t0 = time.perf_counter()
    seq = entry.kitti_loop_sequence(RING_FRAMES, RING_RADIUS, RING_REVOLUTIONS, workers=workers)
    render_s = time.perf_counter() - t0
    system = entry.kitti_loop_system(dev)
    tracker = system.tracker
    cfg = tracker.cfg
    closer = tracker.loop_closer
    _check(closer is not None and closer.fix_scale, "[15b] no loop closer, or a free scale")
    print(f"[15b] KITTI ring: {RING_FRAMES} stereo frames {entry.KITTI_CAM.width}x"
          f"{entry.KITTI_CAM.height} (radius {RING_RADIUS} m, {RING_REVOLUTIONS} laps) rendered "
          f"in {render_s:.1f} s by {workers} processes; {cfg.n_features} features, "
          f"K={cfg.max_keyframes} P={cfg.max_points}, the default vocabulary")
    times = LoopTimes(closer, lc)
    before = {}

    def at_capture(m):
        traj = trajectory_on(tracker.rel_trajectory, m)
        before.update(frames=len(traj), ate=traj_ate(traj, seq.T_true[:len(traj)]))

    times.on_capture = at_capture
    frame_ms, per_frame, loop_frames = [], [], []
    _zero_launches()
    t_seq = time.perf_counter()
    try:
        for i, (t, left, right) in enumerate(seq.frames()):
            c0, loops0 = _launch_counts(), tracker.stats["loops"]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            system.track_stereo(left, right, t)
            end.record()
            end.synchronize()
            frame_ms.append(start.elapsed_time(end))
            c1 = _launch_counts()
            per_frame.append((c1["patch_gather"] - c0["patch_gather"],
                              c1["pose_opt"] - c0["pose_opt"]))
            if tracker.stats["loops"] > loops0:
                loop_frames.append((i, frame_ms[-1]))
        system.shutdown()
    finally:
        times.restore()
    seq_s = time.perf_counter() - t_seq
    launches = _launch_counts()
    stats = dict(tracker.stats)
    ate_end = traj_ate(tracker.export_trajectory(), seq.T_true)
    counts = {}
    for pf in per_frame:
        counts[str(pf)] = counts.get(str(pf), 0) + 1
    print(f"[15b] {stats['loops']} loops, {stats['n_kf']} keyframes ({tracker.n_live_kf} live), "
          f"{stats['lost_frames']} lost, {stats['reloc']} relocalizations, capacity growths "
          f"{tracker.growth_events}; the sequence took {seq_s:.1f} s, per frame median "
          f"{statistics.median(frame_ms):.1f} ms, mean {statistics.mean(frame_ms):.1f} ms on "
          f"CUDA events ({card})")
    if before:
        print(f"[15b] ATE before the first loop ({before['frames']} frames): "
              f"{before['ate']['rmse']:.4f} m; at the end ({len(seq.T_true)} frames, after the "
              f"global BA): {ate_end['rmse']:.4f} m")
    print(f"[15b] loop frames (index, ms): {[(i, round(ms, 1)) for i, ms in loop_frames]}")
    print(f"[15b] launches (patch_gather, pose_opt) per frame: {counts}; total {launches}")
    out = times.report("[15b]", card)
    _check(stats["loops"] >= 1, f"[15b] no loop closed on the ring: {stats}")
    _check(stats["lost_frames"] == 0, f"[15b] lost frames: {stats}")
    _check(not closer.gba_running(), "[15b] a global BA is still pending after shutdown")
    _check(np.isfinite(ate_end["rmse"]), f"[15b] ATE {ate_end}")
    # the loop and its global BA leave the trajectory no farther from the
    # truth than it was before the loop
    _check(bool(before) and ate_end["rmse"] <= before["ate"]["rmse"],
           f"[15b] ATE {ate_end['rmse']} at the end, {before.get('ate')} before the loop")
    _check(all(pg == 3 for pg, _ in per_frame) and all(po >= 2 for _, po in per_frame[1:]),
           f"[15b] launches per frame {counts}")

    # -- 15c. the correction and a global BA chunk against the CPU port
    m0, kf_id, cand, S12, fix = times.captured
    m0 = MapState(*m0)
    cam = tracker.cam
    t0 = time.perf_counter()
    card_m = lc._correct_loop_device(cam, m0, kf_id, cand, S12, fix)
    cpu_m = lc._correct_loop_device(cam, MapState(*[x.cpu() for x in m0]), kf_id.cpu(),
                                    cand.cpu(), S12.cpu(), fix)
    A, B = entry.map_to_numpy(card_m), entry.map_to_numpy(cpu_m)
    live = A["kf_valid"]
    pose_gap = float(np.abs(A["kf_Tcw"][live] - B["kf_Tcw"][live]).max())
    # the card against itself from the same inputs: the pose graph sums
    # in a fixed order (solvers/pose_graph._index_add), so nothing moves
    again_T = lc._correct_loop_device(cam, m0, kf_id, cand, S12, fix).kf_Tcw.cpu().numpy()
    self_gap = float(np.abs(again_T[live] - A["kf_Tcw"][live]).max())
    links = float((A["kf_pt_idx"][live] == B["kf_pt_idx"][live]).mean())
    pv = A["pt_valid"] & B["pt_valid"]
    pt_gap = np.abs(A["pt_xyz"][pv] - B["pt_xyz"][pv]).max(-1)
    pt_share = float((pt_gap <= CORRECT_PT_ATOL).mean())
    prob = lc.LoopCloser._build_gba_prob(card_m)
    cost0 = ba_core._robust_cost(prob, cam)
    lam = torch.full((), 1e-4, device=dev)
    active = torch.ones_like(prob.obs_valid)
    g_card = ba_core.bundle_adjust_partial(prob, cam, lam, cost0, active, iters=4, robust=True)
    cprob = ba_core.BAProblem(*[x.cpu() for x in prob])
    g_cpu = ba_core.bundle_adjust_partial(cprob, cam, lam.cpu(), cost0.cpu(), active.cpu(),
                                          iters=4, robust=True)
    fixed = prob.cam_fixed.cpu()
    gba_gap = float((g_card[0].cam_Tcw.cpu() - g_cpu[0].cam_Tcw).abs()[~fixed].max())
    gba_pt = (g_card[0].pt_xyz.cpu() - g_cpu[0].pt_xyz).abs().max(-1).values[
        prob.pt_valid.cpu()]
    gba_pt_share = float((gba_pt <= CORRECT_PT_ATOL).float().mean())
    print(f"[15c] _correct_loop_device (keyframe {int(kf_id)} to {int(cand)}) card vs CPU from "
          f"the same inputs: live poses {pose_gap:.2e} (bound {CORRECT_POSE_ATOL:g}; the card "
          f"against itself {self_gap:.2e}), links "
          f"{links:.4%} equal (bound {CORRECT_LINKS_MIN:.0%}), points within "
          f"{CORRECT_PT_ATOL:g} on {pt_share:.4%} (bound 99%, largest {pt_gap.max():.2e}); one "
          f"global BA chunk (4 robust LM steps, O={prob.obs_valid.numel()}, "
          f"{int(prob.obs_valid.sum())} valid): poses {gba_gap:.2e} (bound {GBA_POSE_ATOL:g}), "
          f"points within {CORRECT_PT_ATOL:g} on {gba_pt_share:.4%}, cost {float(cost0):.1f} -> "
          f"card {float(g_card[2]):.1f} / CPU {float(g_cpu[2]):.1f}; "
          f"{time.perf_counter() - t0:.1f} s")
    _check(pose_gap <= CORRECT_POSE_ATOL, f"[15c] correction poses {pose_gap}")
    _check(self_gap == 0.0, f"[15c] the card's correction moved {self_gap} between runs")
    _check(links >= CORRECT_LINKS_MIN, f"[15c] correction links {links}")
    _check(pt_share >= 0.99, f"[15c] correction points {pt_share}")
    _check(gba_gap <= GBA_POSE_ATOL, f"[15c] global BA chunk poses {gba_gap}")
    _check(gba_pt_share >= 0.99, f"[15c] global BA chunk points {gba_pt_share}")

    # -- 15d. no host sync in the correction and a global BA chunk
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = lc._correct_loop_device(cam, m0, kf_id, cand, S12, fix)
        chunk = ba_core.bundle_adjust_partial(prob, cam, lam, cost0, active, iters=4,
                                              robust=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _check(torch.equal(again.kf_pt_idx, card_m.kf_pt_idx), "[15d] the rerun's links differ")
    _check(bool(torch.isfinite(chunk[0].cam_Tcw).all()), "[15d] the chunk is not finite")
    print("[15d] _correct_loop_device and one bundle_adjust_partial chunk ran again under "
          "set_sync_debug_mode('error'): no host sync")

    out.update(frames=RING_FRAMES, radius_m=RING_RADIUS, revolutions=RING_REVOLUTIONS,
               render_s=render_s, workers=workers, loops=stats["loops"],
               keyframes=stats["n_kf"], live_keyframes=tracker.n_live_kf,
               lost_frames=stats["lost_frames"], growth_events=tracker.growth_events,
               ate_before_loop_m=before.get("ate", {}).get("rmse"),
               ate_end_m=ate_end["rmse"], frame_ms_median=statistics.median(frame_ms),
               frame_ms_mean=statistics.mean(frame_ms), loop_frames=loop_frames,
               launches_per_frame=counts, launches=launches, ring=seq,
               correct_K=times.K["correct_loop_device"],
               correct_vs_cpu={"pose_gap": pose_gap, "links": links, "pt_share": pt_share,
                               "card_self_gap": self_gap},
               gba_chunk_vs_cpu={"pose_gap": gba_gap, "pt_share": gba_pt_share})
    return out


# [20]: the map past 512 keyframes: tests/test_torch_large_map.py's loop
# map (362 keyframes one degree apart on the out-and-back ring, the loop
# at 361-1) at KITTI width, built at K 512 and grown to 1,024, where the
# pose graph takes its CG branch (solvers/pose_graph.DENSE_MAX_K)
LARGE_N_KF = 362
LARGE_N = 2000
LARGE_WORLD = 16_000  # tests/test_torch_full_capacity_loop.py's wide wall
LARGE_OLD = (512, 196_608)  # (K, P) before the growth
LARGE_NEW = (1024, 393_216)  # after it


def _device_ms(device, fn):
    """(fn(), its ms): CUDA events on the card, the host clock on the CPU."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _large_map_run(device, m_np: dict, S12: np.ndarray) -> dict:
    """[20]'s path on `device`: grow_map from LARGE_OLD to LARGE_NEW, then
    `_correct_loop_device` on the grown map, then one global BA chunk (4
    robust LM steps) from the corrected map; each stage's result and ms."""
    import torch

    from orb_slam2_test_tpu_torch import entry
    from orb_slam2_test_tpu_torch.engine import loop_closing as lc
    from orb_slam2_test_tpu_torch.slam_map.mapstate import MapCapacity, grow_map
    from orb_slam2_test_tpu_torch.solvers import ba_core

    device = torch.device(device)
    old, new = (MapCapacity(max_keyframes=k, max_features=LARGE_N, max_points=p)
                for k, p in (LARGE_OLD, LARGE_NEW))
    cam = entry.LOOP_MAP_CAM
    m0 = entry.map_from_numpy(m_np, device)
    kf, cand = (torch.tensor(x, device=device) for x in (LARGE_N_KF - 1, 1))
    s12 = torch.from_numpy(S12).to(device)
    grown, grow_ms = _device_ms(device, lambda: grow_map(m0, old, new))
    corr, corr_ms = _device_ms(
        device, lambda: lc._correct_loop_device(cam, grown, kf, cand, s12, True))
    prob = lc.LoopCloser._build_gba_prob(corr)
    cost0 = ba_core._robust_cost(prob, cam)
    lam = torch.full((), 1e-4, device=device)
    active = torch.ones_like(prob.obs_valid)
    chunk, chunk_ms = _device_ms(device, lambda: ba_core.bundle_adjust_partial(
        prob, cam, lam, cost0, active, iters=4, robust=True))
    return {"grown": grown, "corrected": corr, "chunk": chunk, "cost0": cost0,
            "prob": prob, "ms": {"grow": grow_ms, "correct": corr_ms, "chunk": chunk_ms}}


def _bitmap_build(device, grown) -> tuple:
    """The observer bitmap rebuilt at the grown shape, as the Tracker
    rebuilds it after a correction or a growth (`build_observer_bitmap`,
    whose `utils.scatter.last_wins` takes an int64 [P K + 1]): the
    [P, K] bitmap, its ms and, on the card, the GiB its peak took above
    what was allocated before it (None on the CPU)."""
    import torch

    from orb_slam2_test_tpu_torch.slam_map.covisibility import build_observer_bitmap

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    bm, ms = _device_ms(device, lambda: build_observer_bitmap(grown))
    extra = ((torch.cuda.max_memory_allocated() - base) / 2 ** 30
             if device.type == "cuda" else None)
    return bm, ms, extra


def _chunk_ab(device, prob, cam, cost0, pairs: int = 2) -> dict:
    """One global BA chunk with its sums over observations in sorted
    order (`utils.scatter.segments`, the package's path on the card)
    and with index_add_'s atomics in their place, in alternating pairs:
    ms (CUDA events) of each."""
    import torch

    from orb_slam2_test_tpu_torch.solvers import ba_core

    lam = torch.full((), 1e-4, device=device)
    active = torch.ones_like(prob.obs_valid)
    sorted_sum = ba_core.segment_sum

    def atomic_sum(n, idx, v, seg=None):
        return sorted_sum(n, idx, v)

    ms = {"sorted": [], "index_add_": []}
    for _ in range(pairs):
        for name, fn in (("sorted", sorted_sum), ("index_add_", atomic_sum)):
            ba_core.segment_sum = fn
            try:
                ms[name].append(_device_ms(device, lambda: ba_core.bundle_adjust_partial(
                    prob, cam, lam, cost0, active, iters=4, robust=True))[1])
            finally:
                ba_core.segment_sum = sorted_sum
    return ms


def _bit_equal(a, b) -> bool:
    """Two tuples of tensors equal bit for bit, field by field."""
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


def _profiled_idle(fn) -> dict:
    """fn() once under torch.profiler, the card's activity only (the
    host's ops would treble the trace's cost): its kernel launches, the
    device's busy ms and idle share over the host's wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    return {"launches": len(kernels), "wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms}


def _large_map_phase(dev, card: str, loop_stats: dict) -> dict:
    """[20]: the growth from 512 to 1,024 keyframe slots, the loop
    correction on the grown map and one global BA chunk, on the card
    twice (bit-equal) and on the CPU port (within [15c]'s bounds); the
    ms of each and the peak memory, beside [15b]'s correction and chunk
    at its own K; the inputs of `_large_map_profile` under
    "profile_inputs"."""
    import torch

    from orb_slam2_test_tpu_torch import entry
    from orb_slam2_test_tpu_torch.solvers import pose_graph

    t_phase = time.perf_counter()
    m_np, T_true = entry.synthetic_loop_map(
        n_kf=LARGE_N_KF, K=LARGE_OLD[0], N=LARGE_N, P=LARGE_OLD[1], n_world=LARGE_WORLD,
        revisit=LARGE_N_KF - 2)
    build_s = time.perf_counter() - t_phase
    kf, cand = LARGE_N_KF - 1, 1
    S12 = (T_true[kf] @ np.linalg.inv(T_true[cand]) @ m_np["kf_Tcw"][cand]
           @ np.linalg.inv(m_np["kf_Tcw"][cand])).astype(np.float32)
    feats = m_np["kf_kp_valid"][:LARGE_N_KF].sum(1)
    _check(pose_graph.DENSE_MAX_K < LARGE_NEW[0], "[20] the grown map is not on the CG branch")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    runs = [_large_map_run(dev, m_np, S12)]
    launches = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    runs.append(_large_map_run(dev, m_np, S12))
    t_cpu = time.perf_counter()
    cpu = _large_map_run("cpu", m_np, S12)
    cpu_s = time.perf_counter() - t_cpu
    g = runs[0]["grown"]
    chunk_ab = _chunk_ab(dev, runs[0]["prob"], entry.LOOP_MAP_CAM, runs[0]["cost0"])
    bitmaps = [_bitmap_build(dev, g) for _ in range(2)]
    bm_cpu, bm_cpu_ms, _ = _bitmap_build("cpu", cpu["grown"])
    bm_equal = all(torch.equal(bm.cpu(), bm_cpu) for bm, _, _ in bitmaps)
    bm_ms, bm_gib = [x[1] for x in bitmaps], max(x[2] for x in bitmaps)
    del bitmaps, bm_cpu

    a, b = runs
    equal = {"grow": _bit_equal(a["grown"], b["grown"]),
             "correct": _bit_equal(a["corrected"], b["corrected"]),
             "chunk": _bit_equal(a["chunk"][0], b["chunk"][0])
             and torch.equal(a["chunk"][2], b["chunk"][2])}
    chunk_self_gap = float((a["chunk"][0].cam_Tcw - b["chunk"][0].cam_Tcw).abs().max())
    grow_cpu = _bit_equal([x.cpu() for x in a["grown"]], cpu["grown"])
    A, B = entry.map_to_numpy(a["corrected"]), entry.map_to_numpy(cpu["corrected"])
    live = A["kf_valid"]
    pose_gap = float(np.abs(A["kf_Tcw"][live] - B["kf_Tcw"][live]).max())
    links = float((A["kf_pt_idx"][live] == B["kf_pt_idx"][live]).mean())
    pv = A["pt_valid"] & B["pt_valid"]
    pt_gap = np.abs(A["pt_xyz"][pv] - B["pt_xyz"][pv]).max(-1)
    pt_share = float((pt_gap <= CORRECT_PT_ATOL).mean())
    cp, pp = a["chunk"][0], cpu["chunk"][0]
    free = ~pp.cam_fixed
    gba_gap = float((cp.cam_Tcw.cpu() - pp.cam_Tcw).abs()[free].max())
    gba_pt = (cp.pt_xyz.cpu() - pp.pt_xyz).abs().max(-1).values[pp.pt_valid]
    gba_pt_share = float((gba_pt <= CORRECT_PT_ATOL).float().mean())
    ms = {k: [r["ms"][k] for r in runs] for k in ("grow", "correct", "chunk")}
    ref = loop_stats.get("loop_flush_ms") or [{}]
    ref_chunks = loop_stats.get("gba_chunk_ms") or []
    print(f"[20] the loop map at KITTI width: {LARGE_N_KF} live keyframes of {LARGE_N} "
          f"features ({feats.min()}-{feats.max()} each), {int(m_np['pt_valid'].sum())} live "
          f"points, built in {build_s:.1f} s; grown from K {LARGE_OLD[0]} / P {LARGE_OLD[1]} "
          f"to {LARGE_NEW[0]} / {LARGE_NEW[1]} (CG above K = {pose_graph.DENSE_MAX_K}), "
          f"the correction {kf} -> {cand}, one global BA chunk over "
          f"{a['prob'].obs_valid.numel()} observation slots "
          f"({int(a['prob'].obs_valid.sum())} valid)")
    print(f"[20] card ms (CUDA events, runs 1 / 2): growth {ms['grow'][0]:.1f} / "
          f"{ms['grow'][1]:.1f}, _correct_loop_device {ms['correct'][0]:.1f} / "
          f"{ms['correct'][1]:.1f}, chunk {ms['chunk'][0]:.1f} / {ms['chunk'][1]:.1f}; "
          f"beside [15b]'s at K = {(loop_stats.get('correct_K') or [None])[0]}: correction "
          f"{ref[0].get('correct_loop_device', float('nan')):.1f}, chunks "
          f"{', '.join(f'{x:.1f}' for x in ref_chunks)} ({card})")
    print(f"[20] the chunk with its sums in sorted order / with index_add_'s atomics, "
          f"alternating pairs: {chunk_ab} ms (CUDA events; {card})")
    print(f"[20] peak memory allocated {peak_gb:.2f} GiB; launches (patch_gather, pose_opt) "
          f"{launches}")
    print(f"[20] the observer bitmap rebuilt at K {LARGE_NEW[0]} / P {LARGE_NEW[1]} "
          f"(build_observer_bitmap; last_wins's int64 [P K + 1] is "
          f"{(LARGE_NEW[0] * LARGE_NEW[1] + 1) * 8 / 2 ** 30:.2f} GiB): card ms (CUDA events, "
          f"runs 1 / 2) {bm_ms[0]:.1f} / {bm_ms[1]:.1f}, its peak {bm_gib:.2f} GiB above what "
          f"was allocated before it; equal to the CPU port's: {bm_equal} (CPU {bm_cpu_ms:.1f} "
          f"ms; {card})")
    print(f"[20] card run 1 vs run 2 bit-equal: {equal} (chunk poses {chunk_self_gap:.2e}); "
          f"card vs CPU port ({cpu_s:.1f} s on the CPU; CPU ms {cpu['ms']}): growth equal "
          f"{grow_cpu}, correction poses {pose_gap:.2e} (bound {CORRECT_POSE_ATOL:g}), links "
          f"{links:.4%} (bound {CORRECT_LINKS_MIN:.0%}), points within {CORRECT_PT_ATOL:g} on "
          f"{pt_share:.4%} (largest {pt_gap.max():.2e}); chunk poses {gba_gap:.2e} (bound "
          f"{GBA_POSE_ATOL:g}), points on {gba_pt_share:.4%}, cost "
          f"{float(a['cost0']):.1f} -> card {float(a['chunk'][2]):.1f} / CPU "
          f"{float(cpu['chunk'][2]):.1f}")
    _check(all(equal.values()), f"[20] two card runs differ: {equal}")
    _check(grow_cpu, "[20] the card's growth differs from the CPU port's")
    _check(pose_gap <= CORRECT_POSE_ATOL, f"[20] correction poses {pose_gap}")
    _check(links >= CORRECT_LINKS_MIN, f"[20] correction links {links}")
    _check(pt_share >= 0.99, f"[20] correction points {pt_share}")
    _check(gba_gap <= GBA_POSE_ATOL, f"[20] chunk poses {gba_gap}")
    _check(gba_pt_share >= 0.99, f"[20] chunk points {gba_pt_share}")
    _check(bool(torch.isfinite(cp.cam_Tcw).all()) and float(a["chunk"][2]) < float(a["cost0"]),
           "[20] the chunk is not finite or did not lower the cost")
    _check(launches == {"patch_gather": 0, "pose_opt": 0},
           f"[20] the correction and the global BA launch neither kernel: {launches}")
    _check(bm_equal, "[20] the card's observer bitmap differs from the CPU port's")
    out = {"n_kf": LARGE_N_KF, "n_features": LARGE_N, "K": LARGE_NEW[0], "P": LARGE_NEW[1],
           "ms": ms, "cpu_ms": cpu["ms"], "cpu_s": cpu_s, "bit_equal": equal,
           "chunk_sorted_vs_index_add_ms": chunk_ab, "peak_memory_gib": peak_gb,
           "bitmap_ms": bm_ms, "bitmap_cpu_ms": bm_cpu_ms, "bitmap_peak_gib": bm_gib,
           "launches": launches,
           "correct_vs_cpu": {"pose_gap": pose_gap, "links": links, "pt_share": pt_share},
           "chunk_vs_cpu": {"pose_gap": gba_gap, "pt_share": gba_pt_share},
           "phase_s": time.perf_counter() - t_phase,
           "profile_inputs": (g, kf, cand, S12)}
    print(f"[20] took {out['phase_s']:.1f} s")
    return out


def _large_map_profile(dev, card: str, inputs) -> dict:
    """[20]'s correction once more under the profiler: its kernel
    launches, the device's busy ms and idle share. Run last, since a
    process that has traced the card runs slower afterwards."""
    import torch

    from orb_slam2_test_tpu_torch import entry
    from orb_slam2_test_tpu_torch.engine import loop_closing as lc

    grown, kf, cand, S12 = inputs
    t0 = time.perf_counter()
    idle = _profiled_idle(lambda: lc._correct_loop_device(
        entry.LOOP_MAP_CAM, grown, torch.tensor(kf, device=dev), torch.tensor(cand, device=dev),
        torch.from_numpy(S12).to(dev), True))
    print(f"[20] the correction at K {grown.kf_valid.shape[0]} under the profiler (after [17]): "
          f"{idle['launches']} kernel launches, device busy {idle['busy_ms']:.1f} of "
          f"{idle['wall_ms']:.1f} ms, idle share {idle['idle_share']:.3f} "
          f"({time.perf_counter() - t0:.1f} s with the trace's processing; {card})")
    return idle


# [16b]: the last joint problem of the JAX package's multi-sequence run
# (runs/multi_seq/run.log: 271 cameras, 53,871 points, 221,108 valid
# observations), as `synthetic_ba_problem`, at --joint-ba-iters 8
DIST_BA_SIZE = (271, 53871, 5)
DIST_BA_ITERS = 8
DIST_BA_SHARDS_ATOL = 5e-4  # 8 shards vs 1 (tests/test_dist_ba.py:47)
DIST_BA_CPU_ATOL = 1e-3  # card vs CPU: float32 index adds in another order
DIST_BA_COLLECTIVES = 15  # per LM iteration at cg_iters 12
# [16c]: three KITTI sequences round-robin, a joint BA every 45 frames
# summed (2 joint BAs and the final one)
MULTI_SEQ_SEEDS = (0, 1, 2)
MULTI_SEQ_FRAMES = 30
MULTI_SEQ_EVERY = 45
MULTI_SEQ_MAX_CAMS = 256
MULTI_SEQ_ATE = 0.05  # the bound of [12]
# the final joint BA per sequence against the sequence's solo solve: the
# reduced camera system is block-diagonal, but the joint LM shares one
# damping and one accept over the summed cost, and 12 CG iterations on
# the joint system (shared step sizes) are not each block's own CG
# (1.6e-3 in a CPU rehearsal of the port)
BLOCK_DIAG_ATOL = 5e-3
JOINT_CPU_ATOL = 1e-3
# a joint BA that follows no tracked frame (the final polish after the
# second joint BA at frame 90) starts from a converged state, and its
# first LM step is accepted whatever its cost (the carry starts at inf,
# as in the JAX program): its cost may rise, by at most this share
POLISH_COST_RTOL = 1e-4


def _dryrun_phase(dev) -> dict:
    """[16a]: entry.dryrun_multichip on a 1-shard mesh on the card."""
    from orb_slam2_test_tpu_torch import entry

    _zero_launches()
    t0 = time.perf_counter()
    out = entry.dryrun_multichip(1, dev)
    launches = _launch_counts()
    print(f"[16a] dryrun_multichip(1): cost {out['cost']:.3f}, descriptors "
          f"{tuple(out['descs'].shape)}, launches {launches}, {time.perf_counter() - t0:.1f} s")
    _check(np.isfinite(out["cost"]), f"[16a] cost {out['cost']}")
    _check(launches["patch_gather"] >= 1, f"[16a] launches {launches}")
    return {"cost": out["cost"], "launches": launches}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dist_ba_phase(dev, card: str) -> dict:
    """[16b]: dist_bundle_adjust at the size of the JAX multi-sequence
    run's last joint problem: 1 shard, 8 shards, a 1-rank NCCL group,
    the CPU port, no host sync, measure_scaling_problem."""
    import torch
    import torch.distributed as dist

    from orb_slam2_test_tpu_torch.parallel import dist_ba, multihost
    from orb_slam2_test_tpu_torch.parallel.multi_map import measure_scaling_problem
    from orb_slam2_test_tpu_torch.solvers.ba_core import BAProblem
    from orb_slam2_test_tpu_torch.utils.synthetic import synthetic_ba_problem

    prob, cam = synthetic_ba_problem(*DIST_BA_SIZE, seed=0, device=dev)
    n_obs = int(prob.obs_valid.sum())
    print(f"[16b] distributed BA: {DIST_BA_SIZE[0]} cameras, {DIST_BA_SIZE[1]} points, "
          f"{prob.obs_valid.numel()} observation slots, {n_obs} valid (the JAX run's last "
          f"joint problem: 271 / 53,871 / 221,108), {DIST_BA_ITERS} LM iterations")
    shard = {n: dist_ba.shard_problem(prob, n) for n in (1, 8)}

    def run(sprob, mesh):
        dist_ba.PSUM.calls = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = dist_ba.dist_bundle_adjust(sprob, cam, mesh, iters=DIST_BA_ITERS)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end), dist_ba.PSUM.calls / DIST_BA_ITERS

    runs = {}
    for n in (1, 8):
        mesh = dist_ba.make_ba_mesh(n, dev)
        run(shard[n], mesh)  # warm-up
        runs[n] = run(shard[n], mesh)

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    det = {}
    try:
        mesh = dist_ba.make_ba_mesh(None, dev)
        _check(mesh.distributed and mesh.size == 1, f"[16b] NCCL mesh {mesh}")
        mine = multihost.make_global_problem(shard[1], mesh)
        run(mine, mesh)  # warm-up: the communicator
        runs["nccl"] = run(mine, mesh)
        # the comparisons run with deterministic index adds (warn_only:
        # cuBLAS warns without CUBLAS_WORKSPACE_CONFIG, and its results
        # on one stream repeat); by atomics two runs of one shard differ
        # by ~3e-4, which would hide what sharding changes
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            det["nccl"] = run(mine, mesh)[0]
            dist.destroy_process_group()
            for n in (1, 8):
                det[n] = run(shard[n], dist_ba.make_ba_mesh(n, dev))[0]
        finally:
            torch.use_deterministic_algorithms(False)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

    cpu_prob = BAProblem(*[x.cpu() for x in shard[1]])
    t0 = time.perf_counter()
    cpu = dist_ba.dist_bundle_adjust(cpu_prob, cam, dist_ba.make_ba_mesh(1, "cpu"),
                                     iters=DIST_BA_ITERS)
    cpu_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for n in (1, 8):
            again = dist_ba.dist_bundle_adjust(shard[n], cam, dist_ba.make_ba_mesh(n, dev),
                                               iters=DIST_BA_ITERS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _check(bool(torch.isfinite(again[0]).all()), "[16b] the no-sync rerun is not finite")

    T1 = runs[1][0][0]
    gaps = {
        "8_vs_1_shard": float((det[8][0] - det[1][0]).abs().max()),
        "8_vs_1_shard_atomics": float((runs[8][0][0] - T1).abs().max()),
        "nccl_vs_1_shard_atomics": float((runs["nccl"][0][0] - T1).abs().max()),
        "card_vs_cpu": float((T1.cpu() - cpu[0]).abs().max()),
    }
    det_equal = all(torch.equal(a, b) for a, b in zip(det["nccl"], det[1]))
    out = {"cameras": DIST_BA_SIZE[0], "points": DIST_BA_SIZE[1], "valid_observations": n_obs,
           "iters": DIST_BA_ITERS, "gaps": gaps, "nccl_equal_deterministic": det_equal,
           "cpu_s": cpu_s}
    for key, (res, ms, per_iter) in runs.items():
        name = f"{key} shard{'s' if key == 8 else ''}" if key != "nccl" else "1-rank NCCL"
        print(f"[16b] {name}: {ms:.1f} ms, {ms / DIST_BA_ITERS:.2f} ms per LM iteration on CUDA "
              f"events, cost {float(res[2]):.1f}, {per_iter:g} collectives per LM iteration "
              f"({card})")
        out[f"ms_{key}"] = ms
        out[f"ms_per_lm_iter_{key}"] = ms / DIST_BA_ITERS
        out[f"collectives_per_lm_iter_{key}"] = per_iter
        _check(per_iter == DIST_BA_COLLECTIVES, f"[16b] {name}: {per_iter} collectives")
        _check(np.isfinite(float(res[2])), f"[16b] {name}: cost {float(res[2])}")
    print(f"[16b] poses, deterministic index adds: 8 shards vs 1 {gaps['8_vs_1_shard']:.2e} "
          f"(bound {DIST_BA_SHARDS_ATOL:g}), 1-rank NCCL equal to 1 shard: {det_equal}; by "
          f"atomics: 8 vs 1 {gaps['8_vs_1_shard_atomics']:.2e}, NCCL vs 1 "
          f"{gaps['nccl_vs_1_shard_atomics']:.2e}; card vs CPU port "
          f"{gaps['card_vs_cpu']:.2e} (bound {DIST_BA_CPU_ATOL:g}; the CPU took {cpu_s:.1f} s); "
          f"1 and 8 shards again under set_sync_debug_mode('error'): no host sync")
    _check(gaps["8_vs_1_shard"] <= DIST_BA_SHARDS_ATOL, f"[16b] 8 vs 1 shard {gaps}")
    _check(det_equal, "[16b] the 1-rank NCCL run differs from the one-process run")
    _check(gaps["card_vs_cpu"] <= DIST_BA_CPU_ATOL, f"[16b] card vs CPU {gaps}")

    t0 = time.perf_counter()
    scaling = measure_scaling_problem(prob, cam, iters=DIST_BA_ITERS, device_counts=[1, 2, 4, 8])
    print(f"[16b] measure_scaling_problem ({time.perf_counter() - t0:.1f} s, {card}): "
          + json.dumps(scaling))
    out["scaling"] = scaling
    return out


def _merged_cost(maps, cams, max_cams, sfs) -> float:
    """The robust cost of the joint problem that joint_bundle_adjust
    builds from these maps, before it moves anything."""
    from orb_slam2_test_tpu_torch.parallel import dist_ba, multi_map

    _, _, merged = multi_map._merged(maps, cams, max_cams, sfs)
    shards, pts = dist_ba._shards(merged.prob, merged.cam, 1)
    return float(dist_ba._local_cost(shards[0], merged.prob.cam_Tcw, pts[0]))


def _multi_seq_phase(dev, card: str, tmp: str) -> dict:
    """[16c]: three KITTI sequences round-robin through cli.run_multi_seq
    with joint BAs; returns the numbers and the final joint BA's inputs."""
    import argparse

    import torch

    from orb_slam2_test_tpu_torch import cli, entry
    from orb_slam2_test_tpu_torch.io.datasets import MemorySequence
    from orb_slam2_test_tpu_torch.parallel import dist_ba, multi_map
    from orb_slam2_test_tpu_torch.slam_map.mapstate import MapState
    from orb_slam2_test_tpu_torch.utils.loop_probes import ate as traj_ate

    t0 = time.perf_counter()
    seqs = entry.kitti_multi_sequence(MULTI_SEQ_SEEDS, MULTI_SEQ_FRAMES, dev)
    systems = [entry.kitti_system(dev) for _ in seqs]
    render_s = time.perf_counter() - t0
    cfg = systems[0].tracker.cfg
    print(f"[16c] {len(seqs)} KITTI stereo sequences (seeds {MULTI_SEQ_SEEDS}), "
          f"{MULTI_SEQ_FRAMES} frames each, {entry.KITTI_CAM.width}x{entry.KITTI_CAM.height}, "
          f"{cfg.n_features} features, K={cfg.max_keyframes} P={cfg.max_points}, "
          f"async_backend={cfg.async_backend}; a joint BA every {MULTI_SEQ_EVERY} frames summed "
          f"and a final one ({render_s:.1f} s to build)")
    per_frame = [[] for _ in systems]
    events = [[] for _ in systems]  # read after the run: no sync per frame
    for i, s in enumerate(systems):
        def counted(left, right, t, _track=s.track_stereo, _i=i):
            c0 = _launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            pose = _track(left, right, t)
            end.record()
            events[_i].append((start, end))
            c1 = _launch_counts()
            per_frame[_i].append((c1["patch_gather"] - c0["patch_gather"],
                                  c1["pose_opt"] - c0["pose_opt"]))
            return pose
        s.track_stereo = counted
    joint_bas = []
    joint = cli.joint_bundle_adjust

    def captured(maps, cams, mesh, **kw):
        before = _merged_cost(maps, cams, kw["max_cams"], kw["scale_factor"])
        new, info = joint(maps, cams, mesh, **kw)
        joint_bas.append({"maps": [MapState(*[x.clone() for x in m]) for m in maps],
                          "cams": list(cams), "kw": kw, "new": new, "info": info,
                          "cost_before": before, "frames": sum(len(p) for p in per_frame)})
        return new, info

    args = argparse.Namespace(devices=None, device=dev, max_frames=None,
                              joint_ba_every=MULTI_SEQ_EVERY, joint_ba_iters=DIST_BA_ITERS,
                              max_cams=MULTI_SEQ_MAX_CAMS, kitti_traj=False,
                              traj_prefix=os.path.join(tmp, "CameraTrajectory"))
    mem = [MemorySequence("stereo", list(seq.frames)) for seq in seqs]
    cli.joint_bundle_adjust = captured
    _zero_launches()
    try:
        summary = cli.run_multi_seq(systems, mem, args)
    finally:
        cli.joint_bundle_adjust = joint
    launches = _launch_counts()
    frame_ms = [[a.elapsed_time(b) for a, b in ev] for ev in events]

    out = {"sequences": len(seqs), "frames_each": MULTI_SEQ_FRAMES, "fps": summary["fps"],
           "wall_s": summary["wall_s"], "launches": launches, "joint_ba": [],
           "median_track_wall_ms": [m * 1e3 for m in summary["median_s"]],
           "median_track_ms": [statistics.median(x) for x in frame_ms]}
    for k, jb in enumerate(joint_bas):
        info = jb["info"]
        polish = k > 0 and jb["frames"] == joint_bas[k - 1]["frames"]
        row = {"cams": info["n_cams"], "pts": info["n_pts"], "obs": info["n_obs"],
               "after_frames": jb["frames"], "cost_before": jb["cost_before"],
               "cost": info["cost"], "solve_ms": info["solve_s"] * 1e3}
        out["joint_ba"].append(row)
        note = " (no frame since the last)" if polish else ""
        print(f"[16c] joint BA {k} after {jb['frames']} frames{note}: cams {row['cams']}, pts "
              f"{row['pts']}, obs {row['obs']}, cost {row['cost_before']!r} -> {row['cost']!r}, "
              f"solve {row['solve_ms']:.1f} ms "
              f"(host clock, device synchronized; {card})")
        if polish:
            _check(row["cost"] <= row["cost_before"] * (1 + POLISH_COST_RTOL),
                   f"[16c] joint BA {k} raised the converged cost beyond {POLISH_COST_RTOL:g}")
        else:
            _check(row["cost"] < row["cost_before"], f"[16c] joint BA {k} did not lower the cost")
    _check(len(joint_bas) == 3, f"[16c] {len(joint_bas)} joint BAs, expected 2 and the final")
    ates = []
    for i, (s, seq) in enumerate(zip(systems, seqs)):
        stats = s.tracker.stats
        ate = traj_ate(s.tracker.export_trajectory(), seq.T_true)
        ates.append(ate["rmse"])
        print(f"[16c] seq {i}: {stats['n_kf']} keyframes, {stats['lost_frames']} lost, ATE "
              f"{ate['rmse']:.4e} m over {ate['n_pairs']} frames, track_stereo median "
              f"{out['median_track_ms'][i]:.1f} ms on CUDA events "
              f"({out['median_track_wall_ms'][i]:.1f} ms host wall), launches per frame "
              f"{sorted(set(per_frame[i]))}")
        _check(stats["lost_frames"] == 0, f"[16c] seq {i}: {stats}")
        _check(per_frame[i][0] == (3, 0) and all(pf == (3, 2) for pf in per_frame[i][1:]),
               f"[16c] seq {i} launches per frame {per_frame[i]}")
        _check(ate["n_pairs"] == MULTI_SEQ_FRAMES and ate["rmse"] <= MULTI_SEQ_ATE,
               f"[16c] seq {i} ATE {ate}")
    out["ate_m"] = ates
    print(f"[16c] {sum(len(p) for p in per_frame)} frames in {summary['wall_s']:.1f} s: "
          f"{summary['fps']:.2f} fps aggregate (host wall, the joint BAs included); launches "
          f"{launches} ({card})")

    # block-diagonal exactness and the CPU port, from the final joint BA's inputs
    final = joint_bas[-1]
    maps, cams, kw = final["maps"], final["cams"], final["kw"]
    sfs = kw["scale_factor"]
    block_gap = 0.0
    for i, m in enumerate(maps):
        part = multi_map.compact_problem(m, scale_factor=sfs[i], max_cams=kw["max_cams"])
        Tcw, _, _ = dist_ba.dist_bundle_adjust(dist_ba.shard_problem(part.prob, 1), cams[i],
                                               dist_ba.make_ba_mesh(1, dev), iters=kw["iters"])
        joint_T = final["new"][i].kf_Tcw[torch.from_numpy(part.kf_ids).to(dev)]
        block_gap = max(block_gap, float((joint_T - Tcw).abs().max()))
    cpu_maps = [MapState(*[x.cpu() for x in m]) for m in maps]
    cpu_new, cpu_info = multi_map.joint_bundle_adjust(
        cpu_maps, cams, dist_ba.make_ba_mesh(1, "cpu"), iters=kw["iters"],
        max_cams=kw["max_cams"], scale_factor=sfs)
    cpu_gap = max(float((a.kf_Tcw.cpu() - b.kf_Tcw)[b.kf_valid].abs().max())
                  for a, b in zip(final["new"], cpu_new))
    print(f"[16c] the final joint BA per sequence vs its solo dist_bundle_adjust: poses within "
          f"{block_gap:.2e} (bound {BLOCK_DIAG_ATOL:g}); again on the CPU port from the same "
          f"maps: poses within {cpu_gap:.2e} (bound {JOINT_CPU_ATOL:g}), cost "
          f"{cpu_info['cost']:.1f} vs {final['info']['cost']:.1f}")
    _check(block_gap <= BLOCK_DIAG_ATOL, f"[16c] block-diagonal gap {block_gap}")
    _check(cpu_gap <= JOINT_CPU_ATOL, f"[16c] card vs CPU joint BA {cpu_gap}")
    out.update(block_diag_gap=block_gap, cpu_gap=cpu_gap)
    return out, final


def _joint_ba_rank(argv: list) -> int:
    """[16d]'s worker, `chip_smoke.py --joint-ba-rank RANK WORLD PORT DIR`:
    this rank of a gloo group on the card runs the joint BA of the maps
    saved in DIR; rank 0 writes the result there."""
    import torch
    import torch.distributed as dist

    from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam2_test_tpu_torch.io.checkpoint import load_map
    from orb_slam2_test_tpu_torch.parallel import dist_ba
    from orb_slam2_test_tpu_torch.parallel.multi_map import joint_bundle_adjust

    rank, world, port, d = int(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    with open(os.path.join(d, "joint.json")) as f:
        spec = json.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        mesh = dist_ba.make_ba_mesh(None, "cuda")
        maps = [load_map(os.path.join(d, f"map{i}.npz"), mesh.device)[0]
                for i in range(spec["n"])]
        torch.use_deterministic_algorithms(True, warn_only=True)
        new, info = joint_bundle_adjust(maps, [PinholeCamera(**c) for c in spec["cams"]], mesh,
                                        iters=spec["iters"], max_cams=spec["max_cams"],
                                        scale_factor=spec["scale_factor"])
        if rank == 0:
            np.savez(os.path.join(d, "ranks.npz"), cost=info["cost"], size=mesh.size,
                     **{f"kf_Tcw{i}": m.kf_Tcw.cpu().numpy() for i, m in enumerate(new)},
                     **{f"pt_xyz{i}": m.pt_xyz.cpu().numpy() for i, m in enumerate(new)})
    finally:
        dist.destroy_process_group()
    return 0


def _two_ranks_phase(final: dict, tmp: str, card: str) -> dict:
    """[16d]: two gloo ranks on the one card against the 2-shard
    one-process run of the final joint BA."""
    import torch

    from orb_slam2_test_tpu_torch.io.checkpoint import save_map
    from orb_slam2_test_tpu_torch.parallel import dist_ba
    from orb_slam2_test_tpu_torch.parallel.multi_map import joint_bundle_adjust
    from orb_slam2_test_tpu_torch.slam_map.mapstate import MapCapacity

    maps, cams, kw = final["maps"], final["cams"], final["kw"]
    for i, m in enumerate(maps):
        cap = MapCapacity(max_keyframes=m.kf_valid.shape[0], max_features=m.kf_uv.shape[1],
                          max_points=m.pt_valid.shape[0])
        save_map(os.path.join(tmp, f"map{i}.npz"), m, cap)
    with open(os.path.join(tmp, "joint.json"), "w") as f:
        json.dump({"n": len(maps), "cams": [c._asdict() for c in cams], "iters": kw["iters"],
                   "max_cams": kw["max_cams"], "scale_factor": kw["scale_factor"]}, f)
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--joint-ba-rank",
                               str(r), "2", str(port), tmp],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(2)]
    results = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=600)
            results.append((p.returncode, so.decode(), se.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks_s = time.perf_counter() - t0
    for rc, so, se in results:
        _check(rc == 0, f"[16d] a rank failed ({rc}):\n{so[-2000:]}\n{se[-4000:]}")
    got = np.load(os.path.join(tmp, "ranks.npz"))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        one, info = joint_bundle_adjust(maps, cams, dist_ba.make_ba_mesh(2, maps[0].kf_Tcw.device),
                                        **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    equal = all(np.array_equal(got[f"kf_Tcw{i}"], m.kf_Tcw.cpu().numpy())
                and np.array_equal(got[f"pt_xyz{i}"], m.pt_xyz.cpu().numpy())
                for i, m in enumerate(one))
    gap = max(float(np.abs(got[f"kf_Tcw{i}"] - m.kf_Tcw.cpu().numpy()).max())
              for i, m in enumerate(one))
    print(f"[16d] two gloo ranks on the one card ({int(got['size'])} shards): cost "
          f"{float(got['cost']):.1f} vs {info['cost']:.1f} for 2 shards in one process; "
          f"poses and points equal: {equal} (largest pose gap {gap:.2e}); both ranks took "
          f"{ranks_s:.1f} s with their start-up ({card})")
    _check(int(got["size"]) == 2, "[16d] the ranks' mesh is not 2 shards")
    _check(equal, f"[16d] the two ranks differ from the one-process run by {gap}")
    return {"equal": equal, "pose_gap": gap, "ranks_s": ranks_s, "cost": float(got["cost"])}


def _parallel_phase(dev, card: str) -> dict:
    """[16a]-[16d]."""
    import tempfile

    dry = _dryrun_phase(dev)
    dba = _dist_ba_phase(dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        multi, final = _multi_seq_phase(dev, card, tmp)
        ranks = _two_ranks_phase(final, tmp, card)
    return {"dryrun": dry, "dist_ba": dba, "multi_seq": multi, "two_ranks": ranks}


# [17]: a live KITTI stereo stream: 30 pairs at KITTI's 10 fps over two
# TCP connections, the device trace over frames 10-19, the poses against
# a direct run of the same frames ([12]'s card bound and ATE bound)
LIVE_FRAMES = 30
LIVE_TRACE = (10, 20)
LIVE_POSE_ATOL = 1e-3
LIVE_ATE_M = 0.05


def _busy_us(intervals) -> float:
    """The union length of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s_, e_ in sorted(intervals):
        if cur_e is None or s_ > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _live_run(dev, live, tmp: str, trace: bool) -> dict:
    """[17]'s live path: a producer thread sends each frame at its
    capture instant (the first frame's send time plus its timestamp's
    offset: KITTI's 10 fps) over two TCP connections (encoding 0) and
    ends both streams; two SocketSources feed
    ApproximateTimeSync(slop=0.02) into cli.run_live on
    `entry.kitti_system(live_viewer_port=0)` with --profile; with
    `trace` a device trace covers frames LIVE_TRACE; a client thread
    fetches /state.json twice meanwhile. Records per frame the launches,
    the upload's host seconds, the state and the capture, send and pose
    instants, and each refresh's parts and launches."""
    import argparse
    import contextlib
    import socket
    import threading
    import urllib.request

    import torch

    from orb_slam2_test_tpu_torch import cli, entry
    from orb_slam2_test_tpu_torch.io.live import (
        ApproximateTimeSync,
        SocketSource,
        send_end,
        send_frame,
    )
    from orb_slam2_test_tpu_torch.utils.profiling import device_trace, profiler

    system = entry.kitti_system(dev, live_viewer_port=0)
    tracker, viewer = system.tracker, system.viewer
    per_frame, uploads, states, refreshes, span_marks = [], [], [], [], {}
    posed_at, trace_s = [], []
    up_s = [0.0]

    upload = tracker._upload

    def timed_upload(img, dtype=None):
        t0 = time.perf_counter()
        out = upload(img, dtype)
        up_s[0] += time.perf_counter() - t0
        return out

    refresh = viewer.refresh

    def counted_refresh():
        before = _launch_counts()
        refresh()
        after = _launch_counts()
        refreshes.append((dict(viewer.last_refresh_s),
                          tuple(after[k] - before[k] for k in ("patch_gather", "pose_opt"))))

    track = system.track_stereo

    def counted_track(left, right, ts):
        i = len(per_frame)
        if i in LIVE_TRACE:
            span_marks[i] = {k: len(v) for k, v in profiler._samples.items()}
        before = _launch_counts()
        up_s[0] = 0.0
        pose = track(left, right, ts)
        after = _launch_counts()
        posed_at.append(time.perf_counter())
        per_frame.append(tuple(after[k] - before[k] for k in ("patch_gather", "pose_opt")))
        uploads.append(up_s[0])
        states.append(system.tracking_state)
        return pose

    tracker._upload, viewer.refresh, system.track_stereo = timed_upload, counted_refresh, \
        counted_track

    servers = [socket.create_server(("127.0.0.1", 0)) for _ in range(2)]
    captured_at, sent_at, fetched, errors = [], [], [], []

    def produce():
        try:
            conns = [socket.create_connection(srv.getsockname()) for srv in servers]
            t0, ts0 = time.perf_counter(), live.frames[0][0]
            for ts, left, right in live.frames:
                captured_at.append(t0 + (ts - ts0))
                time.sleep(max(0.0, captured_at[-1] - time.perf_counter()))
                sent_at.append(time.perf_counter())
                send_frame(conns[0], ts, left)
                send_frame(conns[1], ts, right)
            for c in conns:
                send_end(c)
                c.close()
        except Exception as e:  # raised again on the main thread
            errors.append(e)

    def client():
        # once the viewer's refresh at frame 10 has ended (the next frame
        # has reached it), and again after frame 20
        try:
            for after in LIVE_TRACE:
                t_end = time.monotonic() + 120
                while viewer.counter <= after and time.monotonic() < t_end:
                    time.sleep(0.01)
                with urllib.request.urlopen(f"http://127.0.0.1:{viewer.port}/state.json",
                                            timeout=30) as r:
                    fetched.append(json.loads(r.read()))
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=produce, daemon=True),
               threading.Thread(target=client, daemon=True)]
    for t in threads:
        t.start()
    sources = [SocketSource(sock=srv.accept()[0]) for srv in servers]
    for srv in servers:
        srv.close()
    sync = ApproximateTimeSync(*sources, slop=0.02)
    # the trace starts and ends between frames, before the pair is taken,
    # so that its set-up and export fall outside the track calls (the
    # capture to pose latency still pays for them); run_live asks for a
    # pair again after each idle timeout, so each is done once
    tracing = contextlib.ExitStack()
    next_pair = sync.next_pair

    def traced_next_pair(timeout=None):
        i = len(per_frame)
        if trace and i in LIVE_TRACE and len(trace_s) == LIVE_TRACE.index(i):
            t0 = time.perf_counter()
            if i == LIVE_TRACE[0]:
                tracing.enter_context(device_trace(os.path.join(tmp, "live_trace"), cuda=True))
            else:
                tracing.close()
            trace_s.append(time.perf_counter() - t0)
        return next_pair(timeout)

    sync.next_pair = traced_next_pair
    args = cli.add_live_args(argparse.ArgumentParser()).parse_args(
        ["kitti.yaml", "--profile", "--traj-out", os.path.join(tmp, "live_traj.txt")])
    torch.cuda.synchronize()
    _zero_launches()
    with tracing:
        summary = cli.run_live(system, sync, "stereo", args)
    launches = _launch_counts()
    for t in threads:
        t.join(timeout=60)
    if errors:
        raise errors[0]
    samples = {k: list(v) for k, v in profiler._samples.items()}
    return dict(system=system, summary=summary, launches=launches, per_frame=per_frame,
                uploads=uploads, states=states, refreshes=refreshes, sent=len(sent_at),
                captured_at=captured_at, sent_at=sent_at, posed_at=posed_at,
                trace_s=trace_s, fetched=fetched, span_marks=span_marks, samples=samples,
                served=json.loads(viewer._state_json), dropped=sync.dropped,
                frame_jpg_bytes=len(viewer._frame_jpg))


def _direct_run(dev, live) -> dict:
    """The same uint8 frames through System.track_stereo, one after the
    other, as float32 host arrays (the live path's input). Per frame
    CUDA events and host wall."""
    import torch

    from orb_slam2_test_tpu_torch import entry

    system = entry.kitti_system(dev)
    frames = [(ts, a.astype(np.float32), b.astype(np.float32)) for ts, a, b in live.frames]
    torch.cuda.synchronize()
    events, wall, states = [], [], []
    for ts, a, b in frames:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        system.track_stereo(a, b, ts)
        end.record()
        wall.append((time.perf_counter() - t0) * 1e3)
        events.append((start, end))
        states.append(system.tracking_state)
    system.shutdown()
    return dict(system=system, event_ms=[s_.elapsed_time(e_) for s_, e_ in events],
                wall_ms=wall, states=states)


def _live_vs_direct(lv: dict, dr: dict) -> tuple[float, list]:
    """The exported poses' largest gap and both runs' keyframe ids."""
    ids, trajs = [], []
    for run in (lv, dr):
        m = run["system"].tracker.map
        ids.append(sorted(m.kf_frame_id[m.kf_valid].tolist()))
        trajs.append(run["system"].tracker.export_trajectory())
    _check([t for t, _ in trajs[0]] == [t for t, _ in trajs[1]], "trajectory timestamps differ")
    gap = max(float(np.abs(a - b).max()) for (_, a), (_, b) in zip(*trajs))
    return gap, ids


def _kitti_live_phase(dev, card: str) -> dict:
    """[17]: a live KITTI stereo stream through cli.run_live on the card,
    against a direct run of the same frames."""
    import tempfile

    import torch

    from orb_slam2_test_tpu_torch import entry
    from orb_slam2_test_tpu_torch.utils.loop_probes import ate as traj_ate
    from orb_slam2_test_tpu_torch.utils.profiling import TRACE_FILE, profiler
    from orb_slam2_test_tpu_torch.viz.ar import fit_plane_ransac, tracked_world_points

    t_phase = time.perf_counter()
    live = entry.kitti_live_frames(np.random.default_rng(SEED + 4), LIVE_FRAMES)
    print(f"[17] KITTI live stereo: {LIVE_FRAMES} pairs of {entry.KITTI_CAM.width}x"
          f"{entry.KITTI_CAM.height} uint8 at {entry.KITTI_FPS:g} fps over two TCP connections "
          f"(encoding 0), timestamps from {live.frames[0][0]:.1f}, ApproximateTimeSync slop "
          f"0.02 s, System(live_viewer_port=0) at K={entry.KITTI_CFG.max_keyframes} "
          f"P={entry.KITTI_CFG.max_points}, from an empty map")
    # the direct run before the trace is held against the live run; the
    # one after it shows what a trace leaves behind in the process
    dr = _direct_run(dev, live)
    with tempfile.TemporaryDirectory() as tmp:
        lv = _live_run(dev, live, tmp, trace=True)
        with open(os.path.join(tmp, "live_trace", TRACE_FILE)) as f:
            trace_events = json.load(f)["traceEvents"]
    dr_after = _direct_run(dev, live)
    summary, stats = lv["summary"], lv["system"].tracker.stats
    per_frame = lv["per_frame"]

    # -- tracking, launches and the live-vs-direct gap ------------------
    traj = lv["system"].tracker.export_trajectory()
    ate = traj_ate(traj, live.T_true)
    gap, ids = _live_vs_direct(lv, dr)
    print(f"    states {''.join(x[0] for x in lv['states'])}, {lv['sent']} pairs sent, "
          f"{summary['frames']} tracked, {summary['lost_frames']} lost, {lv['dropped']} "
          f"dropped; keyframes at frames {ids[0]}; ATE {ate['rmse']:.4e} m over "
          f"{ate['n_pairs']} frames")
    print(f"    launches per frame (patch_gather, pose_opt): {per_frame}; total "
          f"{lv['launches']}")
    print(f"[17] live vs direct System.track_stereo of the same frames: keyframe ids "
          f"{ids[0]} / {ids[1]}, states equal {lv['states'] == dr['states']}, exported poses "
          f"within {gap:.3e} (bound {LIVE_POSE_ATOL:g})")
    det_gap = None
    if gap > LIVE_POSE_ATOL or ids[0] != ids[1]:
        # both again with deterministic index adds, as [16b] compares
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with tempfile.TemporaryDirectory() as tmp:
                lv2 = _live_run(dev, live, tmp, trace=False)
            dr2 = _direct_run(dev, live)
        finally:
            torch.use_deterministic_algorithms(False)
        det_gap, ids = _live_vs_direct(lv2, dr2)
        print(f"[17] again with deterministic algorithms: keyframe ids {ids[0]} / {ids[1]}, "
              f"poses within {det_gap:.3e}")
    _check(lv["sent"] == LIVE_FRAMES and summary["frames"] == LIVE_FRAMES,
           f"{lv['sent']} pairs sent, {summary['frames']} tracked")
    _check(summary["lost_frames"] == 0 and all(x == "OK" for x in lv["states"]),
           f"live states {lv['states']}")
    _check(ate["n_pairs"] == LIVE_FRAMES and ate["rmse"] <= LIVE_ATE_M, f"live ATE {ate}")
    _check(per_frame[0] == (3, 0), f"initializing frame launches {per_frame[0]}")
    _check(all(pf == (3, 2) for pf in per_frame[1:]), f"live launches per frame {per_frame}")
    _check(all(r[1] == (0, 0) for r in lv["refreshes"]),
           f"refresh launches {[r[1] for r in lv['refreshes']]}")
    _check(ids[0] == ids[1], f"keyframe ids live {ids[0]} / direct {ids[1]}")
    _check((gap if det_gap is None else det_gap) <= LIVE_POSE_ATOL,
           f"live vs direct poses differ by {gap} (deterministic: {det_gap})")

    # -- timing: the live loop, the direct run, the upload, the refresh --
    def pct(x, q):
        return float(np.percentile(np.asarray(x), q))

    def figures(ms):
        return {"median": pct(ms, 50), "p90": pct(ms, 90), "mean": float(np.mean(ms))}

    live_ev, live_wall = figures(summary["track_event_ms"]), figures(summary["track_ms"])
    # capture to pose: a frame's paced capture instant to the return of
    # its track call; the sends lag their instants while the TCP buffers
    # are full (the tracker behind the camera)
    latency_ms = [(p_ - c_) * 1e3 for p_, c_ in zip(lv["posed_at"], lv["captured_at"])]
    send_lag_ms = [(s_ - c_) * 1e3 for s_, c_ in zip(lv["sent_at"], lv["captured_at"])]
    latency = dict(figures(latency_ms), last=latency_ms[-1])
    # the same frames, live and direct: before the trace against the
    # direct run before it, after the trace against the direct run after
    # it (a process that has traced the card runs slower afterwards)
    windows = {"before": (0, LIVE_TRACE[0], dr), "traced": (*LIVE_TRACE, None),
               "after": (LIVE_TRACE[1], LIVE_FRAMES, dr_after)}
    same_frames = {
        name: {"frames": [a, b - 1],
               "live": figures(summary["track_event_ms"][a:b]),
               "direct": None if ref is None else figures(ref["event_ms"][a:b])}
        for name, (a, b, ref) in windows.items()}
    dir_ev, dir_wall = figures(dr["event_ms"]), figures(dr["wall_ms"])
    after_ev, after_wall = figures(dr_after["event_ms"]), figures(dr_after["wall_ms"])
    for name, w in same_frames.items():
        direct = ("" if w["direct"] is None else
                  f"; direct{' (after the trace)' if name == 'after' else ''} median "
                  f"{w['direct']['median']:.3f}, mean {w['direct']['mean']:.3f}")
        print(f"[17] frames {w['frames'][0]}-{w['frames'][1]} "
              f"({'in' if name == 'traced' else name} the trace), CUDA events ms: live median "
              f"{w['live']['median']:.3f}, mean {w['live']['mean']:.3f}{direct} ({card})")
    up_ms = [u * 1e3 for u in lv["uploads"]]
    up_share = sum(up_ms) / sum(summary["track_ms"])
    ref_ms = {k: statistics.median(r[0][k] * 1e3 for r in lv["refreshes"])
              for k in ("readback", "covisibility", "json", "frame", "total")}
    print(f"[17] capture to pose (a frame's paced capture instant to track_stereo's return, "
          f"host wall): median {latency['median']:.3f}, p90 {latency['p90']:.3f}, mean "
          f"{latency['mean']:.3f}, last frame {latency['last']:.3f} ms; the producer's sends "
          f"lagged their instants by up to {max(send_lag_ms):.3f} ms (TCP buffers full); the "
          f"trace's start and export took {[round(x * 1e3, 3) for x in lv['trace_s']]} ms "
          f"between frames ({card})")
    for name, ev, wall in (("live track call (the pair's dequeue to track_stereo's return, "
                            "the viewer included)", live_ev, live_wall),
                           ("direct track_stereo, host float32", dir_ev, dir_wall),
                           ("direct track_stereo, host float32, after the trace",
                            after_ev, after_wall)):
        print(f"[17] {name}: median {ev['median']:.3f}, p90 {ev['p90']:.3f}, mean "
              f"{ev['mean']:.3f} ms/frame on CUDA events; median {wall['median']:.3f}, p90 "
              f"{wall['p90']:.3f}, mean {wall['mean']:.3f} ms/frame host wall ({card})")
    print(f"[17] upload (Tracker._upload of two float32 1241x376 images from pageable host "
          f"memory, host wall): median {pct(up_ms, 50):.3f} ms, p90 {pct(up_ms, 90):.3f} ms "
          f"per frame, {up_share:.4f} of the live loop's host wall ({card})")
    print(f"[17] refresh ({len(lv['refreshes'])} calls, every {lv['system'].viewer.every} "
          f"frames), median ms: readback {ref_ms['readback']:.3f}, covisibility "
          f"{ref_ms['covisibility']:.3f}, json {ref_ms['json']:.3f}, frame overlay "
          f"{ref_ms['frame']:.3f}, total {ref_ms['total']:.3f}; launches "
          f"{[r[1] for r in lv['refreshes']]}; frame.jpg {lv['frame_jpg_bytes']} bytes "
          f"(OpenCV {'present' if lv['frame_jpg_bytes'] else 'absent'}) ({card})")

    # -- the trace over frames 10-19 against the counters and the spans --
    kernels = [e for e in trace_events if e.get("cat") == "kernel"]
    n_gather = sum("patch_gather_levels_kernel" in e["name"] for e in kernels)
    n_pose = sum("pose_opt_kernel" in e["name"] for e in kernels)
    want = tuple(sum(pf[k] for pf in per_frame[LIVE_TRACE[0]:LIVE_TRACE[1]]) for k in (0, 1))
    timed = [e for e in trace_events if e.get("ph") == "X" and "dur" in e]
    window_us = max(e["ts"] + e["dur"] for e in timed) - min(e["ts"] for e in timed)
    busy_us = _busy_us([(e["ts"], e["ts"] + e["dur"]) for e in kernels])
    n_traced = LIVE_TRACE[1] - LIVE_TRACE[0]
    a, b = lv["span_marks"][LIVE_TRACE[0]], lv["span_marks"][LIVE_TRACE[1]]
    window_spans = {k: (len(v[a.get(k, 0):b.get(k, 0)]),
                        sum(v[a.get(k, 0):b.get(k, 0)]) * 1e3 / n_traced)
                    for k, v in lv["samples"].items() if b.get(k, 0) > a.get(k, 0)}
    print(f"[17] device trace of frames {LIVE_TRACE[0]}-{LIVE_TRACE[1] - 1}: "
          f"{len(kernels)} kernels, patch_gather_levels_kernel {n_gather} and pose_opt_kernel "
          f"{n_pose} (counters {want}); device busy {busy_us / 1e3 / n_traced:.3f} ms per "
          f"frame, window {window_us / 1e3:.1f} ms, device idle share "
          f"{1 - busy_us / window_us:.4f} ({card})")
    print("    spans over the same frames (count, host ms per frame): "
          + ", ".join(f"{k} ({c}, {ms:.3f})" for k, (c, ms) in window_spans.items()))
    _check(n_gather > 0 and n_pose > 0,
           f"the trace holds no kernel of the port ({len(kernels)} kernels)")
    _check((n_gather, n_pose) == want, f"trace counts {(n_gather, n_pose)} != counters {want}")

    # -- the spans, the served state, the plane ----------------------------
    rep = {k: len(v) for k, v in lv["samples"].items()}
    n_frame_spans = rep.get("frame_build", 0) + rep.get("track_frame_fused", 0)
    print(f"    spans over the run: {rep}")
    _check(n_frame_spans == LIVE_FRAMES, f"{n_frame_spans} frame spans")
    # the span wraps the keyframe decision of every OK frame after the
    # initializing one
    _check(rep.get("keyframe_insert", 0) == lv["states"].count("OK") - 1,
           f"{rep.get('keyframe_insert')} keyframe_insert spans")
    _check(len(lv["fetched"]) == 2 and all("kf" in st for st in lv["fetched"]),
           f"/state.json fetched {len(lv['fetched'])} times")
    served = lv["served"]
    m = lv["system"].tracker.map
    Tcw = m.kf_Tcw[m.kf_valid].double().cpu().numpy()
    centres = -np.einsum("nji,nj->ni", Tcw[:, :3, :3], Tcw[:, :3, 3])
    served_kf = np.asarray(served["kf"])
    centre_gap = float(np.abs(served_kf - centres).max()) if len(centres) == len(served_kf) \
        else float("inf")
    print(f"    last served state.json: frame {served['frame']}, {len(served['kf'])} keyframe "
          f"centres within {centre_gap:.2e} m of the map's {len(centres)} live keyframes, "
          f"{served['n_pt']} points, {len(served['edges'])} covisibility edges; fetched during "
          f"the run at frames {[st['frame'] for st in lv['fetched']]}")
    _check(centre_gap <= 1e-3, f"served keyframe centres off by {centre_gap}")
    pts = tracked_world_points(lv["system"].tracker)
    plane_card = fit_plane_ransac(pts, rng=np.random.default_rng(0))
    plane_host = fit_plane_ransac(pts.cpu().numpy(), rng=np.random.default_rng(0))
    same = (plane_card is None) == (plane_host is None) and (plane_card is None or (
        plane_card.n_inliers == plane_host.n_inliers and plane_card.d == plane_host.d
        and np.array_equal(plane_card.normal, plane_host.normal)))
    print(f"    fit_plane_ransac on {pts.shape[0]} tracked points on the card and on their "
          f"numpy copy: equal {same}, "
          f"{None if plane_card is None else plane_card.n_inliers} inliers")
    _check(pts.shape[0] > 0 and same, "fit_plane_ransac differs between the card's points "
                                      "and their numpy copy")
    phase_s = time.perf_counter() - t_phase
    print(f"[17] took {phase_s:.1f} s")
    return {
        "frames": summary["frames"], "sent": lv["sent"], "dropped": lv["dropped"],
        "keyframe_frame_ids": ids[0], "lost_frames": stats["lost_frames"],
        "ate_rmse_m": ate["rmse"], "live_vs_direct_pose_gap": gap,
        "live_vs_direct_pose_gap_deterministic": det_gap,
        "capture_to_pose_ms": latency, "capture_to_pose_frame_ms": latency_ms,
        "send_lag_ms_max": max(send_lag_ms), "trace_start_export_s": lv["trace_s"],
        "live_track_ms": live_ev, "live_track_wall_ms": live_wall,
        "same_frames_ms": same_frames, "direct_ms": dir_ev, "direct_wall_ms": dir_wall,
        "direct_after_trace_ms": after_ev, "direct_after_trace_wall_ms": after_wall,
        "live_track_frame_ms": summary["track_event_ms"], "upload_ms_median": pct(up_ms, 50),
        "upload_share_of_live_wall": up_share, "refresh_ms_median": ref_ms,
        "trace_kernels": {"patch_gather": n_gather, "pose_opt": n_pose},
        "trace_device_busy_ms_per_frame": busy_us / 1e3 / n_traced,
        "trace_device_idle_share": 1 - busy_us / window_us,
        "spans_ms_per_frame_traced": {k: ms for k, (_, ms) in window_spans.items()},
        "launches_per_frame": [list(x) for x in per_frame], "launches": lv["launches"],
        "phase_s": phase_s,
    }


# [18]: the offline tools (tools/) through the CLI's parser on the card.
# [18a] writes [15b]'s ring (the same frames, radius, laps, landmarks and
# seed) as a KITTI dataset; [18b] trains a reduced vocabulary; [18c]
# measures recall on [18a]'s dataset; [18d] sweeps two local-BA windows
# over its frames before the loop (the lap is 157 frames, the loop
# closes at ~172)
VOCAB_SWEEP = (4, 4, 1200)  # [18b]: scenes, frames per scene, features (default 24, 8, 1200)
VOCAB_DEPTH = 4  # [18b]: L (default 5)
RECALL_SPLIT = 157  # [18c]: one lap; the rest revisits the start
RECALL_STRIDE = 2
SWEEP_WINDOWS = (16, 32)
SWEEP_FRAMES = 80  # [18d]: 20 keyframes at [15b]'s cadence, more than the 16-window
SWEEP_POSE_ATOL = 1e-3  # [18d]: the window-16 row vs cli.run, both on the card


def _flip_tie_ratio(raw, bins: np.ndarray, flipped: np.ndarray) -> np.ndarray:
    """|a - b| / max(blur) of each flipped BRIEF bit's two blurred,
    mean-centered float32 taps (`ops.patches.orb_from_patches`'s), over
    the largest value of its patch's blur before the centering: raw
    [N, 38, 38] CPU patches, bins [N] the angle bin whose pattern was
    read, flipped [N, 256] bool. One value per flipped bit. Grey levels
    are >= 0, so the blur's float32 rounding, which is all that parts
    the two devices, moves a - b by a few ulps of that peak."""
    import torch

    from orb_slam2_test_tpu_torch.ops import brief, patches

    n = raw.shape[0]
    _, A, AT, _ = patches._operators(raw.device)
    blurred = ((A @ raw) @ AT).reshape(n, -1)
    peak = blurred.abs().amax(dim=1)
    blurred = blurred - blurred.mean(dim=1, keepdim=True)
    r, k = np.nonzero(flipped)
    taps = torch.from_numpy(brief._binned_pattern_indices()[bins[r], k].astype(np.int64))
    rows = torch.from_numpy(r)
    ta, tb = blurred[rows, taps[:, 0]], blurred[rows, taps[:, 1]]
    return ((ta - tb).abs() / peak[rows].clamp(min=1e-30)).numpy()


def _bits_on_card_patches(raw, angle, desc) -> dict:
    """The CPU port's `orb_from_patches` on host copies of the card's own
    patches raw [N, 38, 38], against the card's angle [N] and desc [N, 8]
    of them: the bits compared where the angle bin agrees, the bits that
    flip, the bin changes, the CPU's angles, and each flipped bit's tie
    ratio (`_flip_tie_ratio`). Both devices run the same float32 gather, so a
    flip can come only from the blur's rounding on each device."""
    import torch

    from orb_slam2_test_tpu_torch.ops import patches

    cpu_angle, cpu_desc = patches.orb_from_patches(raw)
    bins = _bins(angle.numpy())
    same = bins == _bins(cpu_angle.numpy())
    flipped = np.unpackbits((desc.numpy() ^ cpu_desc.numpy()).view(np.uint8), axis=1,
                            bitorder="little")[same].astype(bool)
    rows = torch.from_numpy(same.nonzero()[0])
    return {"bits": int(flipped.size), "flipped": int(flipped.sum()),
            "per_descriptor_max": int(flipped.sum(1).max(initial=0)),
            "bin_changes": int((~same).sum()),
            "cpu_angle": cpu_angle.numpy(),
            "ratios": _flip_tie_ratio(raw[rows], bins[same], flipped)}


def _tool_args(argv: list):
    from orb_slam2_test_tpu_torch import cli

    return cli.build_parser().parse_args(argv)


def _offline_tools_phase(dev, card: str, ring) -> dict:
    """[18a]-[18d]: make_synth_data, build_vocab, vocab_recall and
    ba_window_sweep on the card."""
    import tempfile

    import torch

    from orb_slam2_test_tpu_torch import cli, entry
    from orb_slam2_test_tpu_torch.bow.vocabulary import DEFAULT_VOCABULARY_PATH, build_vocabulary
    from orb_slam2_test_tpu_torch.engine.frame import build_frame_mono
    from orb_slam2_test_tpu_torch.io.datasets import load_kitti
    from orb_slam2_test_tpu_torch.io.trajectory import load_trajectory_tum
    from orb_slam2_test_tpu_torch.ops import extractor
    from orb_slam2_test_tpu_torch.system import System
    from orb_slam2_test_tpu_torch.tools import (
        ba_window_sweep,
        build_vocab,
        make_synth_data,
        vocab_recall,
    )

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # -- 18a. make_synth_data kitti: [15b]'s ring as files
        d = os.path.join(tmp, "ring")
        workers = os.cpu_count() or 1
        n = RING_FRAMES
        argv = ["make_synth_data", "kitti", "--out", d, "--frames", str(n), "--radius",
                str(RING_RADIUS), "--revolutions", str(RING_REVOLUTIONS), "--workers",
                str(workers), "--device", str(dev)]
        _zero_launches()
        t0 = time.perf_counter()
        _check(make_synth_data.main(_tool_args(argv)) == 0, "[18a] make_synth_data failed")
        write_s = time.perf_counter() - t0
        launches = _launch_counts()
        t0 = time.perf_counter()
        seq = load_kitti(d, stereo=True)
        _check(len(seq) == n, f"[18a] {len(seq)} frames read back of {n}")
        for i, it in enumerate(seq.items):
            _, left, right = seq.load(it)
            _check(np.array_equal(left, ring.images[i, 0]) and
                   np.array_equal(right, ring.images[i, 1]),
                   f"[18a] frame {i} differs from render_loop_stereo's")
            _check(abs(it.timestamp - i / ring.fps) < 1e-6, f"[18a] timestamp of frame {i}")
        gt = load_trajectory_tum(os.path.join(d, "groundtruth.txt"))
        # groundtruth.txt holds camera-to-world poses
        gt_gap = max(float(np.abs(np.linalg.inv(T) - T_true).max())
                     for (_, T), T_true in zip(gt, ring.T_true))
        read_s = time.perf_counter() - t0
        print(f"[18a] make_synth_data kitti: {n} stereo frames 1241x376 of [15b]'s ring "
              f"(radius {RING_RADIUS} m, {RING_REVOLUTIONS} laps, {entry.KITTI_LOOP_LANDMARKS} "
              f"landmarks, seed 0) written by {workers} spawned processes in {write_s:.1f} s; "
              f"read back through io.datasets.load_kitti in {read_s:.1f} s: every image "
              f"bit-equal to [15b]'s render_loop_stereo in memory, ground truth within "
              f"{gt_gap:.1e} of its poses; launches {launches}")
        _check(gt_gap <= 1e-5, f"[18a] ground truth off by {gt_gap}")
        _check(launches == {"patch_gather": 0, "pose_opt": 0}, f"[18a] launches {launches}")
        out["make_synth_data"] = {"frames": n, "workers": workers, "write_s": write_s,
                                  "read_s": read_s, "groundtruth_gap": gt_gap}

        # -- 18b. build_vocab on a reduced sweep
        scenes, per_scene, n_feat = VOCAB_SWEEP
        voc_path = os.path.join(tmp, f"vocab_k10_L{VOCAB_DEPTH}.npz")
        argv = ["build_vocab", "--n-scenes", str(scenes), "--frames-per-scene",
                str(per_scene), "--n-features", str(n_feat), "--depth", str(VOCAB_DEPTH),
                "--out", voc_path, "--device", str(dev)]
        extract_ms = []
        extract = build_vocab.extract

        def timed_extract(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            desc = extract(*a, **k)
            end.record()
            end.synchronize()
            extract_ms.append(start.elapsed_time(end))
            return desc

        build_vocab.extract = timed_extract
        _zero_launches()
        try:
            summary = build_vocab.run(_tool_args(argv))
        finally:
            build_vocab.extract = extract
        launches = _launch_counts()
        n_frames = scenes * per_scene
        voc = summary["vocabulary"]
        _, _, cam0, _, img0 = next(build_vocab.synthetic_images(1, 1, 0))
        card_orb = []
        orb_from_patches = extractor.orb_from_patches

        def recorded_orb(raw):
            angle, desc = orb_from_patches(raw)
            card_orb.append((raw.cpu(), angle.cpu(), desc.cpu()))
            return angle, desc
        with _in_place_of(extractor, "orb_from_patches", recorded_orb):
            f_card = build_frame_mono(torch.from_numpy(img0).to(dev), 0.0, cam0,
                                      n_features=n_feat)
        f_cpu = build_frame_mono(torch.from_numpy(img0), 0.0, cam0, n_features=n_feat)
        card_np = [x.cpu().numpy() for x in (f_card.uv, f_card.level, f_card.valid,
                                             f_card.desc)]
        for field, a, b in zip(("uv", "level", "valid"), card_np,
                               (f_cpu.uv, f_cpu.level, f_cpu.valid)):
            _check(np.array_equal(a, b.numpy()), f"[18b] frame 0: card and CPU {field} differ")
        _check(np.array_equal(card_np[3].view(np.uint32)[card_np[2]], summary["frames"][0]),
               "[18b] frame 0: the tool's descriptors are not the frame's")
        # the CPU port on the card's own patches: the same float32 gather,
        # so a bit can differ only at a near-tie of the two blurred taps
        _check(len(card_orb) == 1, f"[18b] {len(card_orb)} orb_from_patches calls in a frame")
        cmp = _bits_on_card_patches(*card_orb[0])
        ratio_max = float(cmp["ratios"].max(initial=0.0))
        desc = np.concatenate(summary["frames"])
        cpu_voc = build_vocabulary(desc, k=10, depth=VOCAB_DEPTH, seed=0, device="cpu")
        same_tree = all(np.array_equal(getattr(voc, f), getattr(cpu_voc, f))
                        for f in ("node_desc", "node_children", "node_is_leaf", "leaf_word",
                                  "word_weight"))
        print(f"[18b] build_vocab: {scenes} scenes x {per_scene} frames x {n_feat} features "
              f"(default 24 x 8 x 1200), k=10, L={VOCAB_DEPTH} (default 5): "
              f"{summary['n_descriptors']} descriptors, {voc.n_words} words, "
              f"{summary['distinct_words']} hit by the re-transform; extraction "
              f"{statistics.median(extract_ms):.2f} ms/frame median on CUDA events "
              f"({summary['extract_s'] * 1e3 / n_frames:.1f} ms/frame host wall with the "
              f"host rendering), k-means {summary['kmeans_s']:.2f} s, idf "
              f"{summary['idf_s']:.3f} s (host wall; {card}); launches {launches}")
        print(f"    frame 0 card vs CPU port: keypoints equal; on the card's patches "
              f"{cmp['flipped']} of {cmp['bits']} BRIEF bits flipped (at most "
              f"{cmp['per_descriptor_max']} in a descriptor), {cmp['bin_changes']} angle bin "
              f"changes, each flip a near-tie of the float32 taps: largest |a - b| / peak "
              f"{ratio_max:.2e} (bound 2^-18 = {FLIP_TIE_RATIO:.2e}); the tree from the "
              f"card's descriptors equal to the CPU port's from the same descriptors: "
              f"{same_tree}")
        _check(launches == {"patch_gather": n_frames, "pose_opt": 0},
               f"[18b] launches {launches} for {n_frames} frames")
        _check(ratio_max <= FLIP_TIE_RATIO,
               f"[18b] a flipped bit {ratio_max} away from a tie of the float32 taps")
        _check(same_tree, "[18b] the card's tree differs from the CPU port's")
        _check(os.path.exists(voc_path), "[18b] no npz written")
        out["build_vocab"] = {
            "scenes": scenes, "frames_per_scene": per_scene, "n_features": n_feat,
            "depth": VOCAB_DEPTH, "n_descriptors": summary["n_descriptors"],
            "n_words": voc.n_words, "distinct_words": summary["distinct_words"],
            "extract_ms_median": statistics.median(extract_ms),
            "extract_wall_s": summary["extract_s"], "kmeans_s": summary["kmeans_s"],
            "idf_s": summary["idf_s"], "flipped_bits": cmp["flipped"],
            "flips_max": cmp["per_descriptor_max"], "flipped_tie_ratio_max": ratio_max,
            "launches": launches}

        # -- 18c. vocab_recall on 18a's dataset, the packaged L6 and 18b's tree
        vocabs = [os.path.normpath(DEFAULT_VOCABULARY_PATH), voc_path]
        _zero_launches()
        t0 = time.perf_counter()
        idx_all, descs, centers = vocab_recall.extract_sequence(d, RECALL_STRIDE, 2000, dev)
        extract_s = time.perf_counter() - t0
        launches = _launch_counts()
        t0 = time.perf_counter()
        rep = vocab_recall.report(d, idx_all, descs, centers, vocabs, RECALL_SPLIT, 8.0, dev)
        report_s = time.perf_counter() - t0
        rep_cpu = vocab_recall.report(d, idx_all, descs, centers, vocabs, RECALL_SPLIT, 8.0,
                                      "cpu", log=lambda *a: None)
        n_reach = vocab_recall.reachable(centers, idx_all[:rep["n_db"]],
                                         idx_all[rep["n_db"]:], 8.0)
        print(f"[18c] vocab_recall on [18a]'s dataset (split {RECALL_SPLIT}, stride "
              f"{RECALL_STRIDE}, 2000 features, radius 8 m): {rep['n_db']} database frames, "
              f"{rep['n_queries']} queries ({n_reach} with a database frame within 8 m); recall "
              f"{json.dumps(rep['vocabs'])}; extraction "
              f"{extract_s:.1f} s, transforms and scoring {report_s:.1f} s (host wall); the "
              f"report from the card's descriptors on the CPU port equal: {rep_cpu == rep}; "
              f"launches {launches}")
        _check(launches == {"patch_gather": len(idx_all), "pose_opt": 0},
               f"[18c] launches {launches} for {len(idx_all)} frames")
        _check(rep_cpu == rep, f"[18c] card report {rep} != CPU report {rep_cpu}")
        _check(rep["n_queries"] > 0, "[18c] no queries")
        out["vocab_recall"] = {"report": rep, "reachable_queries": n_reach,
                               "extract_s": extract_s, "report_s": report_s,
                               "launches": launches}

        # -- 18d. ba_window_sweep at two windows over the frames before the loop
        systems, per_frame = [], []
        track = System.track_stereo

        def counted(self, left, right, t):
            if not systems or systems[-1] is not self:
                systems.append(self)
            c0 = _launch_counts()
            pose = track(self, left, right, t)
            c1 = _launch_counts()
            per_frame.append((len(systems) - 1, c1["patch_gather"] - c0["patch_gather"],
                              c1["pose_opt"] - c0["pose_opt"]))
            return pose

        sweep_json = os.path.join(tmp, "sweep.json")
        argv = ["ba_window_sweep", d, "--windows", *map(str, SWEEP_WINDOWS), "--max-frames",
                str(SWEEP_FRAMES), "--out", sweep_json, "--device", str(dev)]
        System.track_stereo = counted
        _zero_launches()
        t0 = time.perf_counter()
        try:
            _check(ba_window_sweep.main(_tool_args(argv)) == 0, "[18d] ba_window_sweep failed")
        finally:
            System.track_stereo = track
        sweep_s = time.perf_counter() - t0
        launches = _launch_counts()
        with open(sweep_json) as f:
            rows = json.load(f)["rows"]
        # the same frames through cli.run at the yaml's settings
        run_args = _tool_args(["stereo_kitti", os.path.join(d, "settings.yaml"), d,
                               "--max-frames", str(SWEEP_FRAMES), "--device", str(dev),
                               "--traj-out", os.path.join(tmp, "traj.txt"),
                               "--kf-traj-out", os.path.join(tmp, "kf.txt")])
        ref = cli.make_system(run_args, "stereo")
        cli.run(ref, cli.load_sequence("stereo_kitti", run_args, ref), run_args,
                log=lambda *a: None)
        w16 = systems[SWEEP_WINDOWS.index(16)].tracker
        ids = [sorted(t.map.kf_frame_id[t.map.kf_valid].tolist()) for t in (w16, ref.tracker)]
        gap = max(float(np.abs(a - b).max()) for (_, a), (_, b) in
                  zip(w16.export_trajectory(), ref.tracker.export_trajectory()))
        for r in rows:
            print(f"[18d] ba_window_sweep n_local {r['n_local']}: {json.dumps(r)} ({card})")
        print(f"[18d] {len(SWEEP_WINDOWS)} windows over {SWEEP_FRAMES} frames (default 16 / "
              f"32 / 64 over 700) in {sweep_s:.1f} s; the window-16 row against cli.run of "
              f"the same frames at the yaml's settings: keyframe ids equal: {ids[0] == ids[1]} "
              f"({len(ids[0])} live), poses within {gap:.2e} (bound {SWEEP_POSE_ATOL:g}); "
              f"launches {launches}")
        _check(len(systems) == len(SWEEP_WINDOWS), f"[18d] {len(systems)} Systems")
        for s, row in enumerate(rows):
            frames = [(pg, po) for k, pg, po in per_frame if k == s]
            _check(len(frames) == SWEEP_FRAMES and frames[0] == (3, 0)
                   and all(x == (3, 2) for x in frames[1:]),
                   f"[18d] window {row['n_local']}: launches per frame {frames}")
            _check(row["lost_frames"] == 0 and row["loops"] == 0, f"[18d] row {row}")
            _check(row["ate_pairs"] == SWEEP_FRAMES and np.isfinite(row["ate_rmse_m"]),
                   f"[18d] row {row}")
        _check(ids[0] == ids[1], f"[18d] keyframe ids {ids}")
        _check(gap <= SWEEP_POSE_ATOL, f"[18d] window 16 vs cli.run poses {gap}")
        out["ba_window_sweep"] = {"rows": rows, "frames": SWEEP_FRAMES, "sweep_s": sweep_s,
                                  "keyframe_frame_ids_equal_cli_run": ids[0] == ids[1],
                                  "pose_gap_vs_cli_run": gap, "launches": launches}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[18] took {out['phase_s']:.1f} s")
    return out


# [19]: the six dataset commands on datasets written as files, on the
# card, at cut lengths: the first frames of the JAX package's recorded
# runs (the same scene and step per frame), TUM with its 5-frame
# blackout moved from frame 300 of 360 to 40 of 60
DRIVER_DATA = {"euroc": (60, None), "kitti": (40, None), "tum-mono": (60, 40),
               "tum-rgbd": (60, 40)}
# the ATE ceilings, which also bound the relocalized frame's distance
# from the truth: twice the port's CPU rehearsal of the same cuts (0.566,
# 0.407, 0.035, 0.056, 0.885, 0.458 m; PERF.md §5), set before the
# card's first run of [19]
DRIVER_ATE_M = {"mono_euroc": 1.2, "stereo_euroc": 0.8, "mono_kitti": 0.1,
                "stereo_kitti": 0.12, "mono_tum": 1.8, "rgbd_tum": 0.9}
# the first frames again, on the card and on the CPU port: up to this
# many past the card's first tracked frame (a monocular map starts on
# frame 1-6: mono_tum's initialization fails on frame 1 with the port's
# seeded RANSAC draws, PERF.md §6)
DRIVER_CPU_FRAMES = 5
# the card against the CPU port over the frames both track, the CPU port
# reading the card's own BRIEF angles and descriptors (_OrbTape): [12]'s
# bound or, where the card lies beyond it, DRIVER_SPREAD_FACTOR times the
# CPU port's own spread at a fixed precision, its run at 1 thread against
# its run at the default count (another summation order). On these
# scenes that alone moves the poses by up to 8.3e-3 within 5 frames
# (rgbd_tum; stereo_euroc 3.4e-3; PERF.md §6), where the card sits
# 8.8e-3 / 1.0e-3 from the CPU
DRIVER_POSE_ATOL = 1e-3
DRIVER_SPREAD_FACTOR = 2.0
# frame by frame from the card's own state, the one decision that parts
# the devices: the motion model predicts each candidate's octave as
# ceil(log(max_dist / dist) / log 1.2) with max_dist = dist x 1.2^octave
# (engine/tracking._motion_body, as the JAX package does), an integer in
# exact arithmetic whose ceil falls on either side by rounding: the card
# reads 0.99999988 where the CPU reads 1.0000005. A flipped octave moves
# the candidate's window radius by 1.2x and its octave band by one, so 1-3
# motion matches differ, and these scenes' poses by up to 3.0e-3 (PERF.md
# §6). A frame with such a flip is held to DRIVER_FLIP_POSE_ATOL, each flip
# must sit within OCTAVE_TIE of an integer on both devices, and every
# other frame is held to [12]'s DRIVER_POSE_ATOL with equal counts
DRIVER_FLIP_POSE_ATOL = 1e-2
OCTAVE_TIE = 1e-5
# each pose optimization of the card's run again on the CPU through the
# plain version from the same inputs: [3]'s bounds
POSE_CALL_ATOL = 1e-4
POSE_CALL_AGREE = 0.99
# a BRIEF bit that the CPU port reads otherwise on the card's own patches
# is a near-tie of its two float32 taps, |a - b| <= FLIP_TIE_RATIO times
# the peak of the patch's blur (`_flip_tie_ratio`): both devices gather
# the same taps, which part only by the blur's float32 rounding ([4],
# [18b], [19]). On [4]'s frame at two scene seeds, a float64 or reordered
# float32 blur moves the taps by at most 2.9e-7 of the peak (2^-21.7) and
# flips none of 1.02 M bits; a bf16 selection product or a TF32 blur flips
# 576 / 120 of them, 96% / 88% beyond this bound
# (tests/test_torch_brief_selection.py)
FLIP_TIE_RATIO = 2.0**-18
# the CPU's patches against the card's of the same frame, grey levels:
# the same keypoints, the pyramid's rounding apart
PATCH_RAW_ATOL = 1e-2
# the keypoint selection's score maps (FAST scores after the non-maximum
# suppression) on the two devices, relative, where both are nonzero: the
# pyramids' rounding moves them by up to ~7e-6. Where a position and a
# neighbour tie within this before the suppression on both devices, the
# devices may keep different ones of the two (one level of mono_tum's
# first 11 frames; PERF.md §6)
SCORE_RTOL = 1e-5
UNDISTORT_ATOL_PX = 1e-3
# [19d]: right u within 1e-3 px on 99% of the stereo matches either
# device makes (the stereo_match tolerance, PERF.md §6)
STEREO_UR_ATOL_PX = 1e-3
STEREO_UR_SHARE = 0.99
# kernel 1's launches per frame of each sensor
GATHERS_PER_FRAME = {"mono": 1, "rgbd": 1, "stereo": 3}


# [19e]: the capped mono_tum at full length (tools/dataset_runs.FULL:
# 360 frames, blank 300-304, make_synth_data's Tracker.maxFramesBetweenKF:
# 5) with the JAX package's L5 vocabulary. Its ATE is chaotic in float32:
# the CPU port's tracker seeds 0-19 spread it over 0.1096-0.4138 m, and
# since the card computes the BRIEF bits and the initialization's SVDs as
# the CPU does, the card's seeds pair with the CPU's without a shift
# (examples/mono_tum_lockstep.py, PERF.md §5; this run, seed 0, at
# 0.2836-0.2856 m on NVIDIA H100 80GB HBM3, 700.00 W). The bound is the
# CPU port's largest seed plus the 10% the CLI-vs-JAX tests allow
FULL_TUM_VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "orb_slam2_test_tpu",
                              "data", "vocab_k10_L5.npz")
FULL_TUM_ATE_BOUND_M = 1.1 * 0.4138


def _sensor(driver: str) -> str:
    return driver.split("_")[0]


def _trajectory_gap(a_path: str, b_path: str) -> tuple[float, int]:
    """The largest Tcw entry gap over the timestamps both trajectories
    hold, and their count."""
    from orb_slam2_test_tpu_torch.io.trajectory import load_trajectory_tum

    a = {round(t, 6): T for t, T in load_trajectory_tum(a_path)}
    b = {round(t, 6): T for t, T in load_trajectory_tum(b_path)}
    both = sorted(set(a) & set(b))
    gap = max((float(np.abs(np.linalg.inv(a[t]) - np.linalg.inv(b[t])).max()) for t in both),
              default=float("inf"))
    return gap, len(both)


@contextlib.contextmanager
def _in_place_of(module, name: str, fn):
    """module.name is fn inside the block."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _neighbour_ties(pre, pos):
    """[n] bool: whether a 3x3 neighbour of each position of `pos` ([n, 2]
    rows and columns) scores within SCORE_RTOL of it (relative) in the
    map `pre`."""
    import torch

    h, w = pre.shape
    dy, dx = torch.tensor([[-1, -1, -1, 0, 0, 1, 1, 1], [-1, 0, 1, -1, 1, -1, 0, 1]])
    ny, nx = pos[:, :1] + dy, pos[:, 1:] + dx
    inside = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
    own = pre[pos[:, 0], pos[:, 1]][:, None]
    near = (pre[ny.clamp(0, h - 1), nx.clamp(0, w - 1)] - own).abs() <= SCORE_RTOL * own.abs()
    return near & inside


class _OrbTape:
    """`ops.extractor`'s keypoint selection and orb_from_patches, recorded
    on the card and replayed on the CPU. `record()`: each level's score
    map before and after the non-maximum suppression and its chosen
    keypoints, and each call's patches, angles and descriptors, copied to
    the host. `replay()`: call by call, the card's keypoints in place of
    the CPU's. The two suppressed maps must agree within SCORE_RTOL
    wherever both are nonzero; a position that the suppression keeps on
    one device only (a suppression tie) must have a neighbour that ties
    it within SCORE_RTOL before the suppression on both devices; where
    the CPU keeps other keypoints, its selection from its own scores at
    the positions the card's suppression kept must give the card's (such
    a level is kept, by call and level, as a keypoint flip); then the
    card's angles and descriptors in place of the CPU's, for the CPU's own
    patches, which must be the card's within PATCH_RAW_ATOL; the CPU port's
    orb_from_patches runs beside them on the card's own patches, and each
    bit that it reads otherwise in the same angle bin is kept with its tie
    ratio."""

    def __init__(self):
        self.calls = []
        self.levels = []
        self.raw_gap = 0.0
        self.score_gap = 0.0
        self.suppression_ties = 0
        self.untied = 0  # suppression ties without a tied neighbour
        self.keypoint_flips = []  # (orb call, pyramid level) of each replay
        self._at = [0, 0]  # the replay's orb call and level
        self.bits = 0
        self.bin_changes = 0
        self.ratios = [np.zeros(0, np.float32)]

    @contextlib.contextmanager
    def record(self):
        from orb_slam2_test_tpu_torch.ops import extractor, patches

        select, nms = extractor._select_level_keypoints, extractor.nms_3x3
        pre = []

        def suppress(score):
            pre.append(score.cpu())
            return nms(score)

        def level(score, n_keep):
            out = select(score, n_keep)
            self.levels.append((pre.pop(), score.cpu()) + tuple(x.cpu() for x in out))
            return out

        def orb(raw):
            angle, desc = patches.orb_from_patches(raw)
            self.calls.append((raw.cpu(), angle.cpu(), desc.cpu()))
            return angle, desc
        with _in_place_of(extractor, "nms_3x3", suppress), \
                _in_place_of(extractor, "_select_level_keypoints", level), \
                _in_place_of(extractor, "orb_from_patches", orb):
            yield self

    @contextlib.contextmanager
    def replay(self):
        import torch

        from orb_slam2_test_tpu_torch.ops import extractor

        select, nms = extractor._select_level_keypoints, extractor.nms_3x3
        calls, levels = iter(self.calls), iter(self.levels)
        self._at = [0, 0]
        pre = []

        def suppress(score):
            pre.append(score)
            return nms(score)

        def level(score, n_keep):
            pre_card, score_card, *card = next(levels)
            pre_cpu = pre.pop()
            _check(score.shape == score_card.shape,
                   f"replay: a score map {tuple(score.shape)} on the CPU, "
                   f"{tuple(score_card.shape)} on the card")
            both = (score != 0) & (score_card != 0)
            if bool(both.any()):
                self.score_gap = max(self.score_gap, float(
                    ((score - score_card).abs() / score_card.abs())[both].max()))
            pos = ((score != 0) != (score_card != 0)).nonzero()
            if len(pos):
                tied = (_neighbour_ties(pre_cpu, pos) & _neighbour_ties(pre_card, pos)).any(1)
                tied &= (pre_cpu[pos[:, 0], pos[:, 1]] != 0) & (pre_card[pos[:, 0], pos[:, 1]] != 0)
                self.suppression_ties += len(pos)
                self.untied += int((~tied).sum())
            # the keypoints (xy, valid); their responses differ by the rounding
            xy, _, valid = select(score, n_keep)
            if not (torch.equal(xy, card[0]) and torch.equal(valid, card[2])):
                kept = torch.where(score_card != 0, pre_cpu, torch.zeros_like(pre_cpu))
                xy, _, valid = select(kept, n_keep)
                _check(torch.equal(xy, card[0]) and torch.equal(valid, card[2]),
                       "replay: a level's keypoints differ beyond its suppression ties")
                self.keypoint_flips.append(tuple(self._at))
            self._at[1] += 1
            return tuple(x.to(score.device) for x in card)

        def orb(raw):
            raw_card, angle, desc = next(calls)
            self._at = [self._at[0] + 1, 0]
            _check(raw.shape == raw_card.shape,
                   f"replay: patches {tuple(raw.shape)} on the CPU, {tuple(raw_card.shape)} "
                   f"on the card")
            self.raw_gap = max(self.raw_gap, float((raw - raw_card).abs().max()))
            cmp = _bits_on_card_patches(raw_card, angle, desc)
            self.ratios.append(cmp["ratios"])
            self.bits += cmp["bits"]
            self.bin_changes += cmp["bin_changes"]
            return angle, desc
        with _in_place_of(extractor, "nms_3x3", suppress), \
                _in_place_of(extractor, "_select_level_keypoints", level), \
                _in_place_of(extractor, "orb_from_patches", orb):
            yield self
        _check(next(calls, None) is None and next(levels, None) is None,
               "replay: fewer calls on the CPU than on the card")

    def check(self, tag: str) -> dict:
        """The replays' figures, after their checks: the score maps within
        SCORE_RTOL, every suppression tie a near-tie, the patches within
        PATCH_RAW_ATOL, every flipped bit a near-tie."""
        ratios = np.concatenate(self.ratios)
        r = {"calls": len(self.calls), "patch_gap": self.raw_gap, "bits": self.bits,
             "flipped_bits": int(ratios.size), "bin_changes": self.bin_changes,
             "flip_tie_ratio_max": float(ratios.max(initial=0.0)),
             "keypoint_flips": self.keypoint_flips, "score_gap": self.score_gap,
             "suppression_ties": self.suppression_ties, "untied": self.untied}
        _check(r["score_gap"] <= SCORE_RTOL,
               f"{tag} a level's selection scores {r['score_gap']} (relative) from the card's")
        _check(r["untied"] == 0,
               f"{tag} {r['untied']} of {r['suppression_ties']} positions that the suppression "
               f"keeps on one device only tie no neighbour within {SCORE_RTOL:g} on both")
        _check(r["patch_gap"] <= PATCH_RAW_ATOL,
               f"{tag} the CPU's patches {r['patch_gap']} from the card's")
        _check(r["flip_tie_ratio_max"] <= FLIP_TIE_RATIO,
               f"{tag} a flipped bit {r['flip_tie_ratio_max']} away from a tie of the float32 "
               f"taps")
        return r

    @staticmethod
    def describe(r: dict) -> str:
        return (f"keypoints the CPU selects otherwise at (call, level) {r['keypoint_flips']}, "
                f"from scores within {r['score_gap']:.2e} of the card's (bound {SCORE_RTOL:g}; "
                f"{r['suppression_ties']} suppression ties, each tying a neighbour within it on "
                f"both devices); the CPU's patches within "
                f"{r['patch_gap']:.2e} of the card's over {r['calls']} calls (bound "
                f"{PATCH_RAW_ATOL:g}); {r['flipped_bits']} of {r['bits']} bits "
                f"flipped against the CPU port on the card's patches, each a near-tie (largest "
                f"|a - b| / peak {r['flip_tie_ratio_max']:.2e}, bound 2^-18); "
                f"{r['bin_changes']} angle bin changes")


def _pose_opt_calls(calls: list):
    """The Tracker's pose optimizations inside the block, each call's
    camera, inputs and result (Tcw, inliers) appended to calls on the
    host."""
    from orb_slam2_test_tpu_torch.engine import tracking

    opt = tracking.pose_optimization

    def recorded(cam, *args, **kw):
        res = opt(cam, *args, **kw)
        calls.append((cam, [x.cpu() for x in args], kw, res.Tcw.cpu(), res.inliers.cpu()))
        return res
    return _in_place_of(tracking, "pose_optimization", recorded)


def _pose_opt_replay(calls: list) -> tuple[float, float]:
    """Each recorded pose optimization again through the plain version
    on the CPU from the same inputs: the largest Tcw gap and the least
    share of equal inlier flags."""
    from orb_slam2_test_tpu_torch.solvers.pose_opt import _pose_optimization_plain

    gap, agree = 0.0, 1.0
    for cam, args, kw, Tcw, inliers in calls:
        ref = _pose_optimization_plain(cam, *args, **kw)
        gap = max(gap, float((ref.Tcw - Tcw).abs().max()))
        agree = min(agree, float((ref.inliers == inliers).float().mean()))
    return gap, agree


def _motion_octaves(args) -> np.ndarray:
    """The motion model's predicted octave of each candidate before its
    ceil, log(max_dist / dist) / log(scale_factor), computed as
    engine/tracking._motion_body and engine/matchers.search_by_projection
    compute it, from one call's arguments of `_build_and_track_device`,
    on their device."""
    import torch

    from orb_slam2_test_tpu_torch.engine.tracking import level_tables
    from orb_slam2_test_tpu_torch.geometry.camera import backproject
    from orb_slam2_test_tpu_torch.geometry.se3 import se3_apply, se3_inverse

    cam, cfg, _, m, _, _, _, _, vel, T_cr, last_feat_pt, last_frame, ref_kf, _ = args
    last_Tcw = T_cr @ m.kf_Tcw[ref_kf.to(torch.int64)]
    pred = vel @ last_Tcw
    xyz_tmp = se3_apply(se3_inverse(last_Tcw),
                        backproject(cam, last_frame.uv, last_frame.depth))
    has_mp = last_feat_pt >= 0
    xyz = torch.where(has_mp[:, None], m.pt_xyz[last_feat_pt.clamp(min=0).to(torch.int64)],
                      xyz_tmp)
    Ow = -pred[:3, :3].T @ pred[:3, 3]
    dist_c = torch.clamp(torch.linalg.norm(xyz - Ow[None, :], dim=-1), min=1e-6)
    scales, _ = level_tables(cfg.map_capacity, xyz.device)
    max_dist = dist_c * scales[last_frame.level.to(torch.int64)]
    dist = torch.linalg.norm(xyz - Ow, dim=-1)
    log_scale = float(np.log(np.float32(cfg.scale_factor)))
    return (torch.log(max_dist.clamp(min=1e-9) / dist.clamp(min=1e-9)) / log_scale).cpu().numpy()


def _frame_by_frame(driver: str, data: str, dev, n: int) -> dict:
    """[19b] from the card's own state: the command's first `n` frames
    through its System on the card, each frame also tracked on the CPU by
    a copy of the card Tracker's state before it (`entry.tracker_to`)
    that reads the card's keypoints, BRIEF angles and descriptors
    (_OrbTape). After each frame the tracking state, the
    keyframe decision (keyframes made) and the trajectory's length must be
    equal. A frame whose motion model predicts a candidate's octave on
    the other side of an integer on the two devices (`_motion_octaves`;
    each such flip within OCTAVE_TIE of the integer) is held to
    DRIVER_FLIP_POSE_ATOL; every other frame to equal tracked counts and
    DRIVER_POSE_ATOL. Returns the largest pose gap of each kind with its
    frame, and each frame's figures."""
    import torch

    from orb_slam2_test_tpu_torch import cli, entry
    from orb_slam2_test_tpu_torch.engine import tracking
    from orb_slam2_test_tpu_torch.tools import dataset_runs

    settings = os.path.join(data, dataset_runs.DRIVERS[driver][1])
    args = cli.build_parser().parse_args([driver, settings, data, "--device", str(dev)])
    system = cli.make_system(args, cli.DATASETS[driver])
    seq = cli.load_sequence(driver, args, system)
    card = system.tracker
    step = {"mono": lambda tr, f: tr.process_image_mono(f[1], f[0]),
            "stereo": lambda tr, f: tr.process_image_stereo(f[1], f[2], f[0]),
            "rgbd": lambda tr, f: tr.process_image_rgbd(f[1], f[2], f[0])}[seq.kind]
    fused = tracking._build_and_track_device

    def recorded(calls):
        def call(*a):
            calls.append(a)
            return fused(*a)
        return _in_place_of(tracking, "_build_and_track_device", call)

    rows = []
    out = {"frame_gap": 0.0, "frame_gap_at": -1, "flip_gap": 0.0, "flip_gap_at": -1}
    for i, item in enumerate(seq.items[:n]):
        frame = seq.load(item)
        cpu = entry.tracker_to(card, "cpu")
        n_kf = (card.stats["n_kf"], cpu.stats["n_kf"])
        tape, card_calls, cpu_calls = _OrbTape(), [], []
        with tape.record(), recorded(card_calls):
            step(card, frame)
        torch.cuda.synchronize()
        with tape.replay(), recorded(cpu_calls):
            step(cpu, frame)
        rep = tape.check(f"[19b] {driver} frame {i}")
        row = {"frame": i, "state": (card.state, cpu.state),
               "keyframe": (card.stats["n_kf"] - n_kf[0], cpu.stats["n_kf"] - n_kf[1]),
               "trajectory": (len(card.trajectory), len(cpu.trajectory)),
               "tracked": (card.n_tracked, cpu.n_tracked), "octave_flips": 0,
               "flipped_bits": rep["flipped_bits"]}
        _check(all(row[k][0] == row[k][1] for k in ("state", "keyframe", "trajectory"))
               and len(card_calls) == len(cpu_calls),
               f"[19b] {driver} frame {i} from the card's state: {row}")
        if card_calls:
            a, b = _motion_octaves(card_calls[0]), _motion_octaves(cpu_calls[0])
            flips = np.ceil(a) != np.ceil(b)
            off = max(np.abs(a - np.round(a))[flips].max(initial=0.0),
                      np.abs(b - np.round(b))[flips].max(initial=0.0))
            row["octave_flips"] = int(flips.sum())
            _check(off <= OCTAVE_TIE,
                   f"[19b] {driver} frame {i}: a predicted octave flips {off} from an integer")
        if row["trajectory"][0] > (rows[-1]["trajectory"][0] if rows else 0):
            row["pose_gap"] = float(np.abs(card.trajectory[-1][1] - cpu.trajectory[-1][1]).max())
            key = "flip_gap" if row["octave_flips"] else "frame_gap"
            if row["pose_gap"] > out[key]:
                out[key], out[key + "_at"] = row["pose_gap"], i
        _check(row["octave_flips"] > 0 or row["tracked"][0] == row["tracked"][1],
               f"[19b] {driver} frame {i} from the card's state, no octave flipped: {row}; the "
               f"card's counts {card.last_diag}, the CPU's {cpu.last_diag}")
        rows.append(row)
    _check(out["frame_gap"] <= DRIVER_POSE_ATOL and out["flip_gap"] <= DRIVER_FLIP_POSE_ATOL,
           f"[19b] {driver} from the card's state: pose {out['frame_gap']} from the CPU port's "
           f"at frame {out['frame_gap_at']} (no octave flipped; bound {DRIVER_POSE_ATOL}), "
           f"{out['flip_gap']} at frame {out['flip_gap_at']} (a motion-model octave flipped; "
           f"bound {DRIVER_FLIP_POSE_ATOL}); the frames {rows}")
    out["frames"] = rows
    return out


def _distorted_frame(dev, img: np.ndarray, card: str) -> dict:
    """[19c]: one 752x480 frame built with configs/EuRoC.yaml's Camera
    block (its radial-tangential distortion) on the card and on the CPU:
    keypoints equal, undistorted uv within UNDISTORT_ATOL_PX."""
    import torch

    from orb_slam2_test_tpu_torch.engine.frame import build_frame_mono
    from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam2_test_tpu_torch.io.settings import _parse_opencv_yaml

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                           "EuRoC.yaml")) as f:
        raw = _parse_opencv_yaml(f.read())
    cam = PinholeCamera(**{k: float(raw[f"Camera.{k}"])
                           for k in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2")},
                        width=int(raw["Camera.width"]), height=int(raw["Camera.height"]))
    _check(cam.has_distortion and img.shape == (cam.height, cam.width),
           f"[19c] camera {cam}, image {img.shape}")
    _zero_launches()
    f_card = build_frame_mono(torch.from_numpy(img).to(dev), 0.0, cam)
    torch.cuda.synchronize()
    launches = _launch_counts()
    f_cpu = build_frame_mono(torch.from_numpy(img), 0.0, cam)
    same = all(torch.equal(getattr(f_card, k).cpu(), getattr(f_cpu, k))
               for k in ("uv_raw", "level", "valid"))
    valid = f_cpu.valid
    gap = float((f_card.uv.cpu() - f_cpu.uv)[valid].abs().max())
    moved = float((f_cpu.uv - f_cpu.uv_raw)[valid].norm(dim=-1).max())
    print(f"[19c] a 752x480 EuRoC frame with configs/EuRoC.yaml's distortion (k1 {cam.k1}, k2 "
          f"{cam.k2}, p1 {cam.p1}, p2 {cam.p2}): {int(valid.sum())} keypoints, equal to the CPU "
          f"port's {same}; undistorted uv within {gap:.3e} px of the CPU's (bound "
          f"{UNDISTORT_ATOL_PX:g}); undistortion moves keypoints up to {moved:.1f} px; launches "
          f"{launches}")
    _check(same, "[19c] the distorted frame's keypoints differ from the CPU port's")
    _check(gap <= UNDISTORT_ATOL_PX, f"[19c] undistorted uv {gap} px from the CPU's")
    _check(moved > 1.0, f"[19c] undistortion moved the keypoints by {moved} px only")
    _check(launches == {"patch_gather": 1, "pose_opt": 0}, f"[19c] launches {launches}")
    return {"keypoints": int(valid.sum()), "uv_gap_px": gap, "moved_px": moved}


def _rectified_pair(dev, left: np.ndarray, right: np.ndarray) -> dict:
    """[19d]: one EuRoC pair rectified with configs/EuRoC.yaml's real
    LEFT.* / RIGHT.* blocks (OpenCV on the host, as the CPU port does it:
    tests/test_torch_drivers.py holds it equal to the JAX package's),
    then its stereo frame on the card and on the CPU with the card's
    descriptors (_OrbTape): keypoints equal, right u within
    STEREO_UR_ATOL_PX on STEREO_UR_SHARE of the matches either makes."""
    import torch

    from orb_slam2_test_tpu_torch.engine.frame import build_frame_stereo
    from orb_slam2_test_tpu_torch.io.datasets import StereoRectifier
    from orb_slam2_test_tpu_torch.io.settings import load_settings

    s = load_settings(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                                   "EuRoC.yaml"))
    rl, rr = StereoRectifier(s.rectification)(left, right)
    moved = float(np.abs(rl.astype(np.float32) - left).mean())
    cam = s.camera
    kw = dict(n_features=s.n_features, n_levels=s.n_levels, scale_factor=s.scale_factor)
    tape = _OrbTape()
    _zero_launches()
    with tape.record():
        f_card = build_frame_stereo(torch.from_numpy(rl).to(dev), torch.from_numpy(rr).to(dev),
                                    0.0, cam, **kw)
    torch.cuda.synchronize()
    launches = _launch_counts()
    with tape.replay():
        f_cpu = build_frame_stereo(torch.from_numpy(rl), torch.from_numpy(rr), 0.0, cam, **kw)
    # the replay gives the CPU the card's keypoints: its own are the
    # card's when no level's selection flipped
    same = not tape.keypoint_flips and all(torch.equal(getattr(f_card, k).cpu(), getattr(
        f_cpu, k)) for k in ("uv_raw", "level", "valid"))
    ur_card, ur_cpu = f_card.ur.cpu(), f_cpu.ur
    either = (ur_card >= 0) | (ur_cpu >= 0)
    agree = (ur_card >= 0) & (ur_cpu >= 0) & ((ur_card - ur_cpu).abs() <= STEREO_UR_ATOL_PX)
    ur_ok = float(agree[either].float().mean())
    stereo = (int((ur_card >= 0).sum()), int((ur_cpu >= 0).sum()))
    rep = tape.check("[19d]")
    print(f"[19d] an EuRoC pair rectified with configs/EuRoC.yaml's LEFT/RIGHT blocks (mean "
          f"{moved:.2f} grey levels moved; rectified fx {cam.fx:.3f}, bf {cam.bf:.3f}): stereo "
          f"frame keypoints equal to the CPU port's {same}, stereo matches {stereo[0]} / "
          f"{stereo[1]} (card / CPU with the card's descriptors), right u within "
          f"{STEREO_UR_ATOL_PX:g} px on {ur_ok:.4f} of them (bound {STEREO_UR_SHARE:g}); "
          f"{_OrbTape.describe(rep)}; launches {launches}")
    _check(same, "[19d] the rectified pair's keypoints differ from the CPU port's")
    _check(moved > 1.0 and min(stereo) > 0, f"[19d] moved {moved}, stereo matches {stereo}")
    _check(ur_ok >= STEREO_UR_SHARE, f"[19d] right u agrees on {ur_ok} of the matches")
    _check(launches == {"patch_gather": 3, "pose_opt": 0}, f"[19d] launches {launches}")
    return {"mean_grey_moved": moved, "stereo_matches": stereo, "ur_agreement": ur_ok,
            "replay": rep}


def _full_mono_tum(dev, card: str, proc, data: str, tmp: str, svd_calls: dict) -> dict:
    """[19e]: the capped mono_tum at full length through `cli.main` on
    the card, its SVD sites' inputs added to svd_calls."""
    from orb_slam2_test_tpu_torch.tools import dataset_runs

    t0 = time.perf_counter()
    frames, at = dataset_runs.FULL["tum-mono"]
    dataset_runs.finish_dataset(proc, "tum-mono", data, timeout=600)
    blank = list(range(at, at + dataset_runs.BLACKOUT_LEN))
    _zero_launches()
    with _svd_capture(svd_calls):
        r = dataset_runs.run_driver("mono_tum", data, tmp, vocabulary=FULL_TUM_VOCAB,
                                    device=str(dev), tag="mono_tum_full")
    per_frame = r["launches_per_frame"]
    ms = np.asarray(r["frame_s"]) * 1e3
    out = {"frames": frames, "lost_at": r["lost_at"], "relocalized": r["relocalized"],
           "loops": r["loops"], "keyframes": r["keyframes"], "ate_m": r["ate_rmse"],
           "ate_pairs": r["ate_pairs"], "median_ms": float(np.median(ms)),
           "p90_ms": float(np.percentile(ms, 90)),
           "launches": tuple(int(x) for x in np.sum(per_frame, axis=0))}
    print(f"[19e] mono_tum, {frames} frames, L5 ({card}): lost at {out['lost_at']}, "
          f"relocalized {out['relocalized']}, {out['loops']} loops, {out['keyframes']} "
          f"keyframes, ATE {out['ate_m']:.4f} m over {out['ate_pairs']} pairs (bound "
          f"{FULL_TUM_ATE_BOUND_M:.4f} m; the seed spreads of both packages: PERF.md §5); median "
          f"{out['median_ms']:.1f}, p90 {out['p90_ms']:.1f} ms a frame host wall; launches "
          f"{out['launches']}")
    tracked = [i for i in range(1, frames) if r["states"][i] == r["states"][i - 1] == "OK"]
    _check(r["lost_at"] == blank, f"[19e] lost at {r['lost_at']}, blank {blank}")
    _check(r["relocs"] == 1 and [x["frame"] for x in r["relocalized"]] == [blank[-1] + 1],
           f"[19e] relocs {r['relocs']} {r['relocalized']}")
    _check(bool(r["ate_rmse"] <= FULL_TUM_ATE_BOUND_M),
           f"[19e] ATE {r['ate_rmse']} against {FULL_TUM_ATE_BOUND_M}")
    _check(all(pf[0] == GATHERS_PER_FRAME["mono"] for pf in per_frame),
           f"[19e] patch_gather launches per frame {sorted(set(per_frame))}")
    _check(all(per_frame[i][1] >= 2 for i in tracked + [blank[-1] + 1]),
           "[19e] pose_opt launches on tracked and relocalizing frames")
    out["phase_s"] = time.perf_counter() - t0
    print(f"[19e] took {out['phase_s']:.1f} s")
    return out


# [19f]: the seven SVD sites of the monocular path, on the inputs of [19b]'s
# six commands and [19e]'s run: (site, module, function, how its output
# is compared). "null": a null vector, 1 - |v . v64|; "frob": the
# Frobenius gap of its matrix output (F; [R|t]); "sim3": of [sR|t];
# "candidates": of each float64 (R, t) candidate to its nearest in the
# candidate set (the SVD's signs order them otherwise on each backend)
SVD_SITES = (
    ("H / F null vectors", "initializer", "_null_vector", "null"),
    ("rank-2 F", "initializer", "_rank2", "frob"),
    ("E decomposition", "initializer", "_decompose_E", "candidates"),
    ("Faugeras H", "initializer", "_decompose_H", "candidates"),
    ("PnP DLT", "pnp", "_solve_p6p_dlt", "null"),
    ("_extract_rt", "pnp", "_extract_rt", "frob"),
    ("Horn", "sim3_solver", "_horn_batch", "sim3"),
)
# the package's SVD at each site lies within this many times the CPU's
# float32 distance from a float64 SVD, median and largest alike
SVD_CPU_FACTOR = 2.0


def _svd_site_module(name: str):
    import importlib

    return importlib.import_module(f"orb_slam2_test_tpu_torch.solvers.{name}")


@contextlib.contextmanager
def _svd_capture(calls: dict):
    """Each SVD site's inputs inside the block, appended to calls[site]
    as device copies (no host sync)."""
    import torch

    def wrap(site, fn):
        def call(*args):
            calls.setdefault(site, []).append(tuple(
                a.detach().clone() if isinstance(a, torch.Tensor) else a for a in args))
            return fn(*args)
        return call
    with contextlib.ExitStack() as stack:
        for site, mod, fn, _ in SVD_SITES:
            m = _svd_site_module(mod)
            stack.enter_context(_in_place_of(m, fn, wrap(site, getattr(m, fn))))
        yield calls


@contextlib.contextmanager
def _svd_mode(mode: str):
    """torch.linalg.svd inside the block: "default" the card's own
    driver, "gesvd" cuSOLVER's QR-based one, "cpu32" / "cpu64" the CPU's
    in float32 / float64, the factors brought back as float32 to the
    input's device; "shipped" leaves the package as it is."""
    import collections

    import torch

    if mode == "shipped":
        yield
        return
    svd = torch.linalg.svd
    factors = collections.namedtuple("SVD", "U S Vh")

    def call(A, full_matrices=True, *, driver=None):
        if mode in ("default", "gesvd"):
            return svd(A, full_matrices=full_matrices,
                       driver=None if mode == "default" else "gesvd")
        host = A.cpu().double() if mode == "cpu64" else A.cpu()
        return factors(*(x.to(A.device, A.dtype) for x in svd(host, full_matrices=full_matrices)))
    with _in_place_of(torch.linalg, "svd", call):
        yield


def _svd_distances(kind: str, out, ref) -> np.ndarray:
    """One distance per batch element (per float64 candidate for
    "candidates") of a site's output from its float64-SVD output; see
    SVD_SITES."""
    def np64(x):
        return x.detach().cpu().double().numpy()

    if kind == "null":  # [..., 9] or [S, 3, 4]: one vector per leading entry
        v, w = (x.reshape(x.shape[0] if x.ndim > 1 else 1, -1) for x in (np64(out), np64(ref)))
        cos = np.abs((v * w).sum(-1)) / (np.linalg.norm(v, axis=-1) * np.linalg.norm(w, axis=-1))
        return 1.0 - cos
    if kind == "frob" and not isinstance(out, tuple):
        a, b = np64(out), np64(ref)
        return np.linalg.norm((a - b).reshape(-1, 9), axis=-1)
    if kind == "frob":  # [R | t]
        a = np.concatenate([np64(out[0]), np64(out[1])[..., None]], -1)
        b = np.concatenate([np64(ref[0]), np64(ref[1])[..., None]], -1)
        return np.linalg.norm((a - b).reshape(a.shape[0], -1), axis=-1)
    if kind == "sim3":  # [sR | t]
        a = np.concatenate([np64(out[0])[:, None, None] * np64(out[1]), np64(out[2])[..., None]],
                           -1)
        b = np.concatenate([np64(ref[0])[:, None, None] * np64(ref[1]), np64(ref[2])[..., None]],
                           -1)
        return np.linalg.norm((a - b).reshape(a.shape[0], -1), axis=-1)
    a = np.concatenate([np64(out[0]), np64(out[1])[..., None]], -1).reshape(-1, 12)
    b = np.concatenate([np64(ref[0]), np64(ref[1])[..., None]], -1).reshape(-1, 12)
    gaps = np.linalg.norm(b[:, None] - a[None], axis=-1)  # [reference, candidate]
    return gaps.min(1)


def _svd_sites(calls: dict, card: str) -> dict:
    """[19f]: each SVD site's captured calls again under each driver and
    as the package runs them, their distances from the float64 SVD, the
    driver the package's output equals, and the ms per call of each
    driver where the package runs gesvd."""
    t0 = time.perf_counter()
    out = {}
    for site, mod, fn, kind in SVD_SITES:
        f = getattr(_svd_site_module(mod), fn)
        args = calls.get(site, [])
        _check(bool(args), f"[19f] no call of {site} in [19b] or [19e]")
        runs = {}
        for mode in ("cpu64", "default", "gesvd", "cpu32", "shipped"):
            with _svd_mode(mode):
                runs[mode] = [f(*a) for a in args]
        row = {"calls": len(args), "fn": f"{mod}.{fn}"}
        for mode in ("default", "gesvd", "cpu32", "shipped"):
            d = np.concatenate([_svd_distances(kind, o, r)
                                for o, r in zip(runs[mode], runs["cpu64"])])
            _check(bool(np.isfinite(d).all()), f"[19f] {site} {mode}: a distance is not finite")
            row[mode] = {"median": float(np.median(d)), "max": float(d.max()), "n": int(d.size)}
        for mode in ("default", "shipped"):
            row[f"{mode}_over_cpu32"] = max(
                row[mode][q] / max(row["cpu32"][q], 1e-30) for q in ("median", "max"))
        row["driver"] = next((m for m in ("gesvd", "default") if all(
            _same(o, g) for o, g in zip(runs["shipped"], runs[m]))), "neither")
        out[site] = row
        if row["driver"] == "gesvd":
            with _svd_mode("default"):
                row["default_ms"] = _cuda_ms(lambda: [f(*a) for a in args], n=5, warmup=1) \
                    / len(args)
            row["gesvd_ms"] = _cuda_ms(lambda: [f(*a) for a in args], n=5, warmup=1) / len(args)
        print(f"[19f] {site} ({mod}.{fn}, {len(args)} calls, {row['default']['n']} "
              f"distances): from float64, median / max: card default "
              f"{row['default']['median']:.3e} / {row['default']['max']:.3e}, gesvd "
              f"{row['gesvd']['median']:.3e} / {row['gesvd']['max']:.3e}, CPU float32 "
              f"{row['cpu32']['median']:.3e} / {row['cpu32']['max']:.3e}; over the CPU's: "
              f"default {row['default_over_cpu32']:.2f}x, the package ({row['driver']}) "
              f"{row['shipped_over_cpu32']:.2f}x"
              + (f"; {row['default_ms']:.3f} ms a call on the default driver, "
                 f"{row['gesvd_ms']:.3f} ms on gesvd (CUDA events; {card})"
                 if row["driver"] == "gesvd" else ""), flush=True)
    for site, row in out.items():
        _check(row["shipped_over_cpu32"] <= SVD_CPU_FACTOR,
               f"[19f] {site}: the package's SVD lies {row['shipped_over_cpu32']:.2f}x the "
               f"CPU's float32 distance from float64 (bound {SVD_CPU_FACTOR}x)")
    print(f"[19f] took {time.perf_counter() - t0:.1f} s")
    return out


def _same(a, b) -> bool:
    """Whether two site outputs (a tensor or a tuple of them) are equal."""
    import torch

    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def _dataset_drivers_phase(dev, card: str) -> dict:
    """[19a]-[19e]: the six dataset commands from files on the card."""
    import tempfile

    import torch

    from orb_slam2_test_tpu_torch.evaluation import aligned_errors
    from orb_slam2_test_tpu_torch.io.datasets import load_euroc
    from orb_slam2_test_tpu_torch.io.trajectory import load_trajectory_tum
    from orb_slam2_test_tpu_torch.tools import dataset_runs

    t_phase = time.perf_counter()
    out = {"runs": {}}
    svd_calls = {}  # [19f]'s inputs, from [19b] and [19e]
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
        # -- 19a. the datasets, rendered at once in processes of their own,
        # [19e]'s full-length TUM mono beside them
        t0 = time.perf_counter()
        full_tum = os.path.join(tmp, "tum-mono-full")
        full_proc = dataset_runs.start_dataset("tum-mono", full_tum,
                                               blackout_at=dataset_runs.FULL["tum-mono"][1])
        stack.callback(full_proc.kill)
        workers = max(1, (os.cpu_count() or 1) - len(DRIVER_DATA))
        procs = {kind: dataset_runs.start_dataset(
            kind, os.path.join(tmp, kind), n, at, workers=workers if kind == "kitti" else 1)
            for kind, (n, at) in DRIVER_DATA.items()}
        try:
            for kind, proc in procs.items():
                dataset_runs.finish_dataset(proc, kind, os.path.join(tmp, kind), timeout=600)
        finally:
            for proc in procs.values():
                proc.kill()
        out["datasets_s"] = time.perf_counter() - t0
        print(f"[19a] datasets written in {out['datasets_s']:.1f} s by make_synth_data "
              f"processes: " + ", ".join(
                  f"{k} {n} frames (of {dataset_runs.FULL[k][0]})"
                  + (f", blank {at}-{at + dataset_runs.BLACKOUT_LEN - 1}" if at else "")
                  for k, (n, at) in DRIVER_DATA.items()))
        # -- 19b. each command on the card, its first frames again on the
        # card and on the CPU port with the card's descriptors
        for driver, (kind, _) in dataset_runs.DRIVERS.items():
            data = os.path.join(tmp, kind)
            n, at = DRIVER_DATA[kind]
            sensor = _sensor(driver)
            t0 = time.perf_counter()
            _zero_launches()
            with _svd_capture(svd_calls):
                r = dataset_runs.run_driver(driver, data, tmp, device=str(dev))
            wall = time.perf_counter() - t0
            # the first frames again on each device: a longer run's later
            # local BAs move its exported early poses
            n_cmp = DRIVER_CPU_FRAMES + next(
                (i for i, s_ in enumerate(r["states"]) if s_ == "OK"), 0)
            tape, opt_calls = _OrbTape(), []
            with tape.record(), _pose_opt_calls(opt_calls):
                short = dataset_runs.run_driver(driver, data, tmp, device=str(dev),
                                                max_frames=n_cmp, tag=f"{driver}_short")
            opt_gap, opt_agree = _pose_opt_replay(opt_calls)
            threads = torch.get_num_threads()
            with tape.replay():
                cpu = dataset_runs.run_driver(driver, data, tmp, device="cpu",
                                              max_frames=n_cmp, tag=f"{driver}_cpu")
            gap, n_both = _trajectory_gap(short["paths"]["traj.txt"], cpu["paths"]["traj.txt"])
            # the CPU port's own spread, at 1 thread: the bound reads it
            # only where the card sits beyond [12]'s
            spread = None
            if gap > DRIVER_POSE_ATOL:
                torch.set_num_threads(1)
                try:
                    with tape.replay():
                        cpu1 = dataset_runs.run_driver(
                            driver, data, tmp, device="cpu", max_frames=n_cmp,
                            tag=f"{driver}_cpu1")
                finally:
                    torch.set_num_threads(threads)
                spread, _ = _trajectory_gap(cpu1["paths"]["traj.txt"], cpu["paths"]["traj.txt"])
            pose_bound = max(DRIVER_POSE_ATOL, DRIVER_SPREAD_FACTOR * (spread or 0.0))
            rep = tape.check(f"[19b] {driver}")
            by_frame = _frame_by_frame(driver, data, dev, n_cmp)
            per_frame = r["launches_per_frame"]
            totals = tuple(int(x) for x in np.sum(per_frame, axis=0))
            blank = list(range(at, at + dataset_runs.BLACKOUT_LEN)) if at else []
            ms = np.asarray(r["frame_s"]) * 1e3
            tracked = [i for i in range(1, n) if r["states"][i] == r["states"][i - 1] == "OK"]
            kinds = sorted(set(per_frame))
            times, err, _ = aligned_errors(load_trajectory_tum(r["paths"]["traj.txt"]),
                                           load_trajectory_tum(os.path.join(
                                               data, "groundtruth.txt")),
                                           with_scale=sensor == "mono")
            before = None
            if at:
                early = err[times < r["timestamps"][at]]
                before = float(early.max()) if early.size else float("nan")
            row = {"frames": n, "keyframes": r["keyframes"], "lost": r["lost_frames"],
                   "lost_at": r["lost_at"], "relocs": r["relocs"], "loops": r["loops"],
                   "ate_m": r["ate_rmse"], "ate_pairs": r["ate_pairs"],
                   "relocalized": r["relocalized"], "max_err_before_blackout_m": before,
                   "median_ms": float(np.median(ms)), "p90_ms": float(np.percentile(ms, 90)),
                   "wall_s": wall, "launches": totals, "launch_kinds": kinds,
                   "cpu_gap": gap, "cpu_frames_compared": n_both,
                   "cpu_threads_spread": spread, "cpu_threads": threads, "pose_bound": pose_bound,
                   "pose_opt_calls": len(opt_calls), "pose_opt_call_gap": opt_gap,
                   "pose_opt_inlier_agreement": opt_agree, "replay": rep,
                   "frame_by_frame": {k: v for k, v in by_frame.items() if k != "frames"},
                   "compare_s": time.perf_counter() - t0 - wall,
                   "states": "".join(s_[0] for s_ in r["states"])}
            out["runs"][driver] = row
            print(f"[19b] {driver} on {kind} ({n} frames, {card}): states {row['states']}; "
                  f"{row['keyframes']} keyframes, {row['lost']} lost at {row['lost_at']}, "
                  f"{row['relocs']} relocs {row['relocalized']} (frames before the blackout up "
                  f"to {before} m from the truth), {row['loops']} loops, ATE "
                  f"{row['ate_m']:.4f} m over {row['ate_pairs']} pairs (ceiling "
                  f"{DRIVER_ATE_M[driver]}); median {row['median_ms']:.1f}, p90 "
                  f"{row['p90_ms']:.1f} ms a frame host wall; launches {totals}, per frame "
                  f"{kinds}; {wall:.1f} s")
            print(f"    its first {n_cmp} frames vs the CPU port's with the card's "
                  f"descriptors: poses within {gap:.3e} over {n_both} frames (the CPU at 1 "
                  f"against {threads} threads "
                  f"{'not run' if spread is None else format(spread, '.3e')}; bound "
                  f"{pose_bound:.3e}); its "
                  f"{len(opt_calls)} pose optimizations again through the plain version on the "
                  f"CPU: Tcw within {opt_gap:.2e} (bound {POSE_CALL_ATOL:g}), inliers "
                  f"{opt_agree:.4f} equal; {_OrbTape.describe(rep)}; {row['compare_s']:.1f} s")
            print(f"    frame by frame from the card's own state: states and keyframe decisions "
                  f"equal; poses within {by_frame['frame_gap']:.3e} (frame "
                  f"{by_frame['frame_gap_at']}; bound {DRIVER_POSE_ATOL:g}, no spread) where no "
                  f"motion-model octave flipped, {by_frame['flip_gap']:.3e} (frame "
                  f"{by_frame['flip_gap_at']}; bound {DRIVER_FLIP_POSE_ATOL:g}) where one did; "
                  f"per frame (keyframes made, tracked card / CPU, octave flips, pose gap) "
                  f"{[(r['keyframe'][0], r['tracked'], r['octave_flips'], r.get('pose_gap')) for r in by_frame['frames']]}")
            _check(r["lost_at"] == blank,
                   f"[19b] {driver} lost at {r['lost_at']}, blank {blank}")
            _check(r["relocs"] == len(blank[-1:]) and [x["frame"] for x in r["relocalized"]]
                   == [b_ + 1 for b_ in blank[-1:]],
                   f"[19b] {driver} relocs {r['relocs']} {r['relocalized']}")
            _check(all(x["err_m"] <= DRIVER_ATE_M[driver] for x in r["relocalized"]),
                   f"[19b] {driver} relocalized {r['relocalized']}")
            _check(np.isfinite(r["ate_rmse"]) and r["ate_rmse"] <= DRIVER_ATE_M[driver],
                   f"[19b] {driver} ATE {r['ate_rmse']}")
            _check(all(pf[0] == GATHERS_PER_FRAME[sensor] for pf in per_frame),
                   f"[19b] {driver} patch_gather launches per frame {kinds}")
            _check(all(per_frame[i][1] >= 2 for i in tracked),
                   f"[19b] {driver} pose_opt launches on tracked frames {kinds}")
            _check(all(per_frame[x["frame"]][1] >= 2 for x in r["relocalized"]),
                   f"[19b] {driver} pose_opt launches on the relocalizing frame")
            _check(short["states"] == cpu["states"] and n_both >= DRIVER_CPU_FRAMES - 2
                   and gap <= pose_bound,
                   f"[19b] {driver} card vs CPU: states {short['states']} / {cpu['states']}, "
                   f"poses {gap} over {n_both} frames")
            _check(bool(opt_calls) and opt_gap <= POSE_CALL_ATOL and opt_agree >= POSE_CALL_AGREE,
                   f"[19b] {driver} {len(opt_calls)} pose optimizations vs plain: Tcw {opt_gap}, "
                   f"inliers {opt_agree}")
        # -- 19c / 19d. distortion and the real rectification
        seq = load_euroc(os.path.join(tmp, "euroc"), stereo=True)
        _, left, right = seq.load(seq.items[0])
        out["distorted_frame"] = _distorted_frame(dev, left, card)
        out["rectified_pair"] = _rectified_pair(dev, left, right)
        # -- 19e. the capped mono_tum at full length
        out["mono_tum_full"] = _full_mono_tum(dev, card, full_proc, full_tum, tmp, svd_calls)
        # -- 19f. the SVD sites on 19b's and 19e's inputs
        out["svd_sites"] = _svd_sites(svd_calls, card)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[19] took {out['phase_s']:.1f} s")
    return out


_ALLBIN = {}


def _allbin_bits(blurred, bin_id):
    """The BRIEF bits in the JAX package's form, the one the port ran on
    the card before its tap gather, timed beside it only: every bin's
    256 signed taps as one bf16 product [N, 1024] x [1024, 7680] with
    float32 accumulation, then each keypoint's own bin."""
    import torch

    from orb_slam2_test_tpu_torch.ops import patches

    dev = blurred.device
    if dev not in _ALLBIN:
        taps = patches._operators(dev)[3].reshape(-1, 2)
        cols = torch.arange(taps.shape[0], device=dev)
        D = torch.zeros(blurred.shape[1], taps.shape[0], device=dev)
        D.index_put_((taps[:, 0], cols), torch.ones_like(cols, dtype=D.dtype), accumulate=True)
        D.index_put_((taps[:, 1], cols), -torch.ones_like(cols, dtype=D.dtype), accumulate=True)
        _ALLBIN[dev] = D.to(torch.bfloat16)
    n = blurred.shape[0]
    vals = (blurred.to(torch.bfloat16) @ _ALLBIN[dev]).reshape(n, -1, 256)
    return vals[torch.arange(n, device=dev), bin_id] < 0.0


BRIEF_AB_PAIRS = 3


def _brief_ab(fns: dict, label: str, card: str) -> dict:
    """Each fn() on CUDA events (`_cuda_ms`) with the package's BRIEF tap
    gather and with `_allbin_bits` in its place, BRIEF_AB_PAIRS times in
    alternating pairs; prints and returns both lists of ms."""
    from orb_slam2_test_tpu_torch.ops import patches

    out = {}
    for name, fn in fns.items():
        gather, product = [], []
        for _ in range(BRIEF_AB_PAIRS):
            gather.append(_cuda_ms(fn))
            with _in_place_of(patches, "brief_bits", _allbin_bits):
                product.append(_cuda_ms(fn))
        out[name] = {"gather_ms": gather, "product_ms": product}
        print(f"{label} {name}, BRIEF by tap gather / by the all-bin bf16 product, "
              f"{BRIEF_AB_PAIRS} alternating pairs (ms on CUDA events, {card}): "
              + ", ".join(f"{g:.4f} / {p:.4f}" for g, p in zip(gather, product)))
    return out


def _bins(angle: np.ndarray) -> np.ndarray:
    return np.round(np.mod(angle, 2 * np.pi) * (30 / (2 * np.pi))).astype(int) % 30


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "one CUDA card", file=sys.stderr)
        return 1

    from orb_slam2_test_tpu_torch import entry
    from orb_slam2_test_tpu_torch.engine.frame import build_frame_mono, build_frame_stereo
    from orb_slam2_test_tpu_torch.ops import extractor, patches
    from orb_slam2_test_tpu_torch.ops.extractor import level_feature_budget
    from orb_slam2_test_tpu_torch.ops.patches import orb_from_patches
    from orb_slam2_test_tpu_torch.ops.pyramid import build_pyramid
    from orb_slam2_test_tpu_torch.solvers import pose_opt, pose_opt_cuda
    from orb_slam2_test_tpu_torch.utils import cuda_build
    from orb_slam2_test_tpu_torch.utils.precision import f32_matmuls

    t_run = time.perf_counter()
    dev = torch.device("cuda", 0)
    f32_matmuls()
    rng = np.random.default_rng(SEED)
    card = _card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} ({card})")

    # -- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    _, info = cuda_build.load_library()
    print(f"[1] build: {info.path.name} in {info.seconds:.2f} s nvcc "
          f"({time.perf_counter() - t0:.2f} s with load, cached={info.cached})")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            print("    ptxas:", line.strip())

    # -- 2. patch_gather vs plain, all 8 levels of a 640x480 frame -------
    img = torch.from_numpy(entry.texture_image(rng, 480, 640)).to(dev).float()
    pyr = build_pyramid(img, entry.N_LEVELS, entry.SCALE_FACTOR)
    budgets = level_feature_budget(entry.N_FEATURES, entry.N_LEVELS, entry.SCALE_FACTOR)
    level_xy = []
    for level_img, n_l in zip(pyr, budgets):
        h, w = level_img.shape
        xy = np.stack([rng.uniform(-5, w + 5, n_l), rng.uniform(-5, h + 5, n_l)], 1)
        xy[: n_l // 4] = np.round(xy[: n_l // 4]) + 0.5  # half-way: rounds to even
        level_xy.append(torch.from_numpy(xy.astype(np.float32)).to(dev))
    mono_xy = torch.cat(level_xy)
    got = patches.extract_raw_patches_levels_cuda(pyr, mono_xy, budgets)
    ref = patches.extract_raw_patches_levels_plain(pyr, mono_xy, budgets)
    torch.cuda.synchronize()
    _check(torch.equal(got, ref), "patch_gather (8 levels, one launch) != plain")
    patch_err = float((got - ref).abs().max())
    for level_img, xy in zip(pyr, level_xy):
        got = patches.extract_raw_patches_cuda(level_img, xy)
        ref = patches.extract_raw_patches_plain(level_img, xy)
        torch.cuda.synchronize()
        _check(torch.equal(got, ref), f"patch_gather != plain at {tuple(level_img.shape)}")
        patch_err = max(patch_err, float((got - ref).abs().max()))
    print(f"[2] patch_gather: bit-exact on {len(pyr)} levels in one launch and level "
          f"by level, n_l={budgets}, shapes={[tuple(p.shape) for p in pyr]}")

    # -- 3. pose_opt vs plain at O = 1000 --------------------------------
    cam_p, T_true_p, T0_p, X_p, obs_p = entry.pose_problem(rng)
    O = X_p.shape[0]
    pose_args = (
        torch.from_numpy(T0_p).float().to(dev), torch.from_numpy(X_p).to(dev),
        torch.from_numpy(obs_p).to(dev), torch.ones(O, device=dev),
        torch.ones(O, dtype=torch.bool, device=dev),
    )
    k_T, k_inl, k_n, k_chi2 = pose_opt_cuda.pose_optimization_cuda(cam_p, *pose_args)
    ref = pose_opt._pose_optimization_plain(cam_p, *pose_args)
    torch.cuda.synchronize()
    pose_err = float((k_T - ref.Tcw).abs().max())
    agree = float((k_inl == ref.inliers).float().mean())
    chi2_ok = torch.allclose(k_chi2, ref.chi2, rtol=1e-3, atol=1e-3)
    print(f"[3] pose_opt: |T - plain| = {pose_err:.3e}, inlier agreement "
          f"{agree:.4f}, n_inliers {int(k_n)} (plain {int(ref.n_inliers)}), "
          f"|T - T_true| = {np.abs(k_T.cpu().numpy() - T_true_p).max():.3e}")
    _check(pose_err <= 1e-4, f"pose_opt Tcw differs from plain by {pose_err}")
    _check(agree > 0.99, f"pose_opt inlier agreement {agree}")
    _check(chi2_ok, "pose_opt chi2 differs from plain beyond rtol 1e-3")
    _check(int(k_n) == int(k_inl.sum()), "pose_opt n_inliers != its inlier count")

    # -- 4. the slice: tracking_step at 640x480 / 1000 / 2048 ------------
    cam = entry.CAM
    img_np, scene, T_true, T_pred = entry.example_scene(rng, dev)
    n_valid = int(scene[2].sum())
    state_card = entry.state_from_numpy(img_np, *scene, T_pred, device=dev)
    state_cpu = entry.state_from_numpy(img_np, *scene, T_pred, device="cpu")

    patches.PATCH_GATHER.launches = 0
    pose_opt_cuda.POSE_OPT.launches = 0
    Tcw, n_inl = entry.tracking_step(*state_card)
    torch.cuda.synchronize()
    launches = {"patch_gather": patches.PATCH_GATHER.launches,
                "pose_opt": pose_opt_cuda.POSE_OPT.launches}
    Tcw, n_inl = Tcw.cpu().numpy(), int(n_inl)
    print(f"[4] slice: launches {launches}, n_inliers {n_inl} of {n_valid} "
          f"valid map points")
    _check(launches == {"patch_gather": 1, "pose_opt": 1}, f"launches {launches}")
    _check(np.isfinite(Tcw).all(), "non-finite pose")
    t_err = float(np.abs(Tcw[:3, 3] - T_true[:3, 3]).max())
    print(f"    translation error {t_err:.3e} m, rotation error "
          f"{np.abs(Tcw[:3, :3] - T_true[:3, :3]).max():.3e}")
    _check(t_err < 1e-2, f"translation error {t_err} m")
    _check(n_inl >= 0.8 * n_valid, f"{n_inl} inliers of {n_valid}")

    Tcw_cpu, n_inl_cpu = entry.tracking_step(*state_cpu)
    Tcw_cpu, n_inl_cpu = Tcw_cpu.numpy(), int(n_inl_cpu)
    cpu_err = float(np.abs(Tcw - Tcw_cpu).max())
    print(f"    vs CPU: |T - T_cpu| = {cpu_err:.3e}, n_inliers {n_inl} vs {n_inl_cpu}")
    _check(cpu_err <= 1e-4, f"card vs CPU pose differs by {cpu_err}")
    _check(abs(n_inl - n_inl_cpu) <= 0.01 * max(n_inl, n_inl_cpu),
           f"n_inliers {n_inl} vs CPU {n_inl_cpu}")

    card_orb = []

    def recorded_orb(raw):
        angle, desc = orb_from_patches(raw)
        card_orb.append((raw.cpu(), angle.cpu(), desc.cpu()))
        return angle, desc
    with _in_place_of(extractor, "orb_from_patches", recorded_orb):
        frame_card = build_frame_mono(torch.from_numpy(img_np).to(dev), 0.0, cam)
    frame_np = type(frame_card)(*[x.cpu().numpy() for x in frame_card])
    frame_cpu = build_frame_mono(torch.from_numpy(img_np), 0.0, cam)
    for field in ("uv", "level", "valid"):
        _check(np.array_equal(getattr(frame_np, field), getattr(frame_cpu, field).numpy()),
               f"card and CPU frames differ in {field}")
    # the CPU port's orb_from_patches on the card's own patches: the same
    # float32 gather, so the devices part only by the blur's and the
    # moments' rounding
    _check(len(card_orb) == 1, f"{len(card_orb)} orb_from_patches calls in a frame")
    a_card = card_orb[0][1].numpy()
    cmp = _bits_on_card_patches(*card_orb[0])
    a_cpu = cmp["cpu_angle"]
    same_bin = _bins(a_card) == _bins(a_cpu)
    # a bin may differ only where the angle lies within 1e-3 rad of a
    # bin boundary (half-way between bin centres)
    frac = np.mod(a_cpu * 30 / (2 * np.pi), 1.0)
    near_edge = np.abs(frac - 0.5) * (2 * np.pi / 30) < 1e-3
    _check(bool(np.all(same_bin | near_edge)),
           "an angle-bin change away from a bin boundary")
    ratio_max = float(cmp["ratios"].max(initial=0.0))
    print(f"    BRIEF on the card's patches, card vs CPU port: {cmp['flipped']} of "
          f"{cmp['bits']} bits flipped (at most {cmp['per_descriptor_max']} in a descriptor), "
          f"largest tie ratio {ratio_max:.2e} (bound 2^-18); angle max diff "
          f"{np.abs(a_card - a_cpu).max(initial=0.0):.2e}; {cmp['bin_changes']} bin changes")
    _check(cmp["per_descriptor_max"] <= 3, f"{cmp['per_descriptor_max']} flipped bits")
    _check(ratio_max <= FLIP_TIE_RATIO,
           f"a flipped bit {ratio_max} away from a tie of the float32 taps")

    # -- 5. timing -------------------------------------------------------
    mono_library = _unfold_gathers([(pyr, mono_xy, budgets)])
    _check(torch.equal(torch.cat([v[y0, x0] for v, y0, x0 in mono_library]),
                       patches.extract_raw_patches_levels_plain(pyr, mono_xy, budgets)),
           "the unfold indexing differs from the plain gather (mono)")
    g_args, _ = patches.gather_launch_args(pyr, mono_xy, budgets)
    p_args, _ = pose_opt_cuda.pose_opt_launch_args(cam_p, *pose_args)
    times = {  # (alone, per call through the wrapper, plain, library)
        "patch_gather": (
            _loop_ms(lambda: patches.PATCH_GATHER(*g_args)),
            _loop_ms(lambda: patches.extract_raw_patches_levels(pyr, mono_xy, budgets)),
            _loop_ms(lambda: patches.extract_raw_patches_levels_plain(pyr, mono_xy, budgets)),
            _loop_ms(lambda: [v[y0, x0] for v, y0, x0 in mono_library]),
        ),
        "pose_opt": (
            _loop_ms(lambda: pose_opt_cuda.POSE_OPT(*p_args)),
            _loop_ms(lambda: pose_opt.pose_optimization(cam_p, *pose_args)),
            _loop_ms(lambda: pose_opt._pose_optimization_plain(cam_p, *pose_args),
                     n=5, warmup=1),
            None,
        ),
    }
    step_ms_mono = _cuda_ms(lambda: entry.tracking_step(*state_card))
    t0 = time.perf_counter()
    for _ in range(N_TIMED):
        entry.tracking_step(*state_card)
    torch.cuda.synchronize()
    step_wall_ms = (time.perf_counter() - t0) * 1e3 / N_TIMED
    bounds_mono = {"patch_gather": _bound(_gather_bytes(pyr, mono_xy), 0),
                   "pose_opt": _pose_bound(pose_args[1], pose_args[4])}
    for name, (k_ms, c_ms, p_ms, l_ms) in times.items():
        b_ms, b_by = bounds_mono[name]
        lib = "n/a" if l_ms is None else f"{l_ms:.4f} ms"
        print(f"[5] {name}: alone {k_ms:.4f} ms, per call {c_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, library {lib}; bound {b_ms:.6f} ms ({b_by}), {b_ms / k_ms:.2%} "
              f"of it alone (one launch: the mono frame's 8 levels / O = {O}; {card})")
    print(f"[5] tracking_step: {step_ms_mono:.3f} ms/frame on CUDA events, "
          f"{step_wall_ms:.3f} ms/frame host wall ({card})")
    raw_mono, img_mono = card_orb[0][0].to(dev), torch.from_numpy(img_np).to(dev)
    brief_ab = {"mono": _brief_ab({
        f"orb_from_patches (N = {raw_mono.shape[0]})": lambda: orb_from_patches(raw_mono),
        "build_frame_mono": lambda: build_frame_mono(img_mono, 0.0, cam)}, "[5]", card)}

    # -- 6. the main path: one KITTI stereo frame --------------------------
    from orb_slam2_test_tpu_torch.engine import tracking
    from orb_slam2_test_tpu_torch.ops import stereo
    from orb_slam2_test_tpu_torch.ops.extractor import extract_orb

    kcam, kcfg = entry.KITTI_CAM, entry.KITTI_CFG
    t0 = time.perf_counter()
    scene = entry.kitti_scene(np.random.default_rng(SEED + 1), dev)
    kin = entry.scene_inputs(scene, dev)
    torch.cuda.synchronize()
    print(f"[6] KITTI scene: {kcam.width}x{kcam.height}, {kcfg.n_features} features, "
          f"K={kcfg.max_keyframes} P={kcfg.max_points}, {entry.KITTI_N_KF} keyframes / "
          f"{entry.KITTI_N_PT} points live, {scene.n_scene} scene points, bitmap "
          f"{tuple(kin[1].shape)} {kin[1].dtype} ({time.perf_counter() - t0:.1f} s set-up)")

    patches.PATCH_GATHER.launches = 0
    pose_opt_cuda.POSE_OPT.launches = 0
    kframe, kouts = entry.track_frame_step(*kin)
    torch.cuda.synchronize()
    k_launches = {"patch_gather": patches.PATCH_GATHER.launches,
                  "pose_opt": pose_opt_cuda.POSE_OPT.launches}
    T_k = kouts[5].cpu().numpy()
    n_inl_k, n_valid_k = int(kouts[6]), int(kframe.valid.sum())
    stereo_k = kframe.ur.cpu().numpy() >= 0
    t_err_k = float(np.abs(T_k[:3, 3] - scene.T_true[:3, 3]).max())
    print(f"    launches {k_launches}; motion: {int(kouts[0])} matches, {int(kouts[1])} "
          f"inliers; local map: {n_inl_k} inliers of {scene.n_scene} scene points, "
          f"translation error {t_err_k:.3e} m; stereo depth on {int(stereo_k.sum())} "
          f"of {n_valid_k} valid features; close {int(kouts[10])} tracked / "
          f"{int(kouts[11])} untracked")
    _check(k_launches == {"patch_gather": 3, "pose_opt": 2}, f"launches {k_launches}")
    for i, o in enumerate(kouts):
        _check(bool(torch.isfinite(o.float()).all()), f"output {i} not finite")
    _check(t_err_k < 1e-2, f"KITTI translation error {t_err_k} m")
    _check(n_inl_k >= 0.8 * scene.n_scene, f"{n_inl_k} inliers of {scene.n_scene}")
    _check(stereo_k.sum() >= 0.5 * n_valid_k, f"stereo on {stereo_k.sum()} of {n_valid_k}")

    cframe, couts = entry.track_frame_step(*entry.scene_inputs(scene, "cpu"))
    cpu_err_k = float(np.abs(T_k - couts[5].numpy()).max())
    stereo_c = cframe.ur.numpy() >= 0
    n_xor = int((stereo_k ^ stereo_c).sum())
    print(f"    vs CPU: |T - T_cpu| = {cpu_err_k:.3e}, n_inliers {n_inl_k} vs "
          f"{int(couts[6])}, stereo-valid sets differ on {n_xor} features")
    _check(cpu_err_k <= 1e-4, f"KITTI card vs CPU pose differs by {cpu_err_k}")
    _check(abs(n_inl_k - int(couts[6])) <= 0.01 * max(n_inl_k, int(couts[6])),
           f"KITTI n_inliers {n_inl_k} vs CPU {int(couts[6])}")
    _check(n_xor <= 0.01 * kcfg.n_features, f"stereo-valid sets differ on {n_xor}")

    # -- 7. both kernels on that frame's inputs ------------------------------
    img_l, img_r = kin[2].float(), kin[3].float()
    lp = build_pyramid(img_l, kcfg.n_levels, kcfg.scale_factor)
    rp = build_pyramid(img_r, kcfg.n_levels, kcfg.scale_factor)
    kw = dict(n_features=kcfg.n_features, n_levels=kcfg.n_levels,
              scale_factor=kcfg.scale_factor)
    fl = extract_orb(img_l, pyramid=lp, **kw)
    fr = extract_orb(img_r, pyramid=rp, **kw)
    max_disp = kcam.bf / (kcam.bf / kcam.width)  # as stereo_match computes it
    _, j = stereo.associate(fl, fr, max_disp, kcfg.n_levels, kcfg.scale_factor)
    sc = stereo.sad_coordinates(fl, fr, j, **kw)
    left_levels = [lp[l] for l in sc.levels]
    right_levels = [rp[l] for l in sc.levels]
    # the 3 launches of one stereo frame: each image's keypoints (in level
    # coordinates) and the SAD windows of both sides
    frame_gathers = [
        (left_levels, sc.xy_l, sc.counts),
        (right_levels, fr.uv * sc.inv_s[:, None], sc.counts),
        (left_levels + right_levels, torch.cat([sc.xy_l, sc.xy_r]), sc.counts * 2),
    ]
    for images, xy, counts in frame_gathers:
        got = patches.extract_raw_patches_levels_cuda(images, xy, counts)
        ref = patches.extract_raw_patches_levels_plain(images, xy, counts)
        torch.cuda.synchronize()
        _check(torch.equal(got, ref), f"patch_gather != plain on {len(images)} images")
        patch_err = max(patch_err, float((got - ref).abs().max()))
    shapes = np.repeat([rp[l].shape for l in sc.levels], sc.counts, axis=0)
    corner = np.round(sc.xy_r.cpu().numpy()[:, ::-1]) - patches.PATCH_EX // 2  # (y0, x0)
    n_clipped = int(((corner < 0) | (corner > shapes - patches.PATCH_EX)).any(1).sum())
    print(f"[7] patch_gather: bit-exact on the SAD coordinates of both sides "
          f"({len(sc.levels)} levels x 2 images, one launch; {n_clipped} of "
          f"{kcfg.n_features} right windows clipped at a border) and on each "
          f"image's keypoints")

    m_k, bm_k = kin[0], kin[1]
    _, _, lm_feat = tracking._local_map_matches(
        kcam, kcfg, m_k, bm_k, kframe, kouts[2], kouts[13])
    X_k = m_k.pt_xyz[lm_feat.clamp(min=0).long()]
    lm_args = tracking._pose_inputs(kcfg, kframe, X_k, lm_feat >= 0)
    n_obs = int(lm_args[3].sum())
    n_stereo_rows = int((lm_args[3] & (lm_args[1][:, 2] >= 0)).sum())
    k2 = pose_opt.pose_optimization(kcam, kouts[2], *lm_args)
    k2_ref = pose_opt._pose_optimization_plain(kcam, kouts[2], *lm_args)
    torch.cuda.synchronize()
    pose_err_k = float((k2.Tcw - k2_ref.Tcw).abs().max())
    agree_k = float((k2.inliers == k2_ref.inliers).float().mean())
    print(f"    pose_opt on the local-map problem (O={lm_args[0].shape[0]}, {n_obs} "
          f"observations, {n_stereo_rows} stereo rows): |T - plain| = "
          f"{pose_err_k:.3e}, inlier agreement {agree_k:.4f}, |T - track| = "
          f"{float((k2.Tcw - kouts[5]).abs().max()):.3e}")
    _check(n_stereo_rows > 0.3 * n_obs, f"{n_stereo_rows} stereo rows of {n_obs}")
    _check(pose_err_k <= 1e-4, f"pose_opt (KITTI) differs from plain by {pose_err_k}")
    _check(agree_k > 0.99, f"pose_opt (KITTI) inlier agreement {agree_k}")
    _check(torch.allclose(k2.chi2, k2_ref.chi2, rtol=1e-3, atol=1e-3),
           "pose_opt (KITTI) chi2 differs from plain beyond rtol 1e-3")
    _check(int(k2.n_inliers) == int(k2.inliers.sum()), "pose_opt (KITTI) n_inliers")
    pose_err = max(pose_err, pose_err_k)

    # -- 8. one RGB-D frame at 640x480 / 1000 features -----------------------
    rcfg = tracking.TrackerConfig(n_features=1000)
    rscene = entry.tracking_scene(
        np.random.default_rng(SEED + 2), "rgbd", entry.RGBD_CAM, rcfg, 100, 20000, dev)
    rin = entry.scene_inputs(rscene, dev)
    patches.PATCH_GATHER.launches = 0
    pose_opt_cuda.POSE_OPT.launches = 0
    rframe, routs = tracking._build_and_track_device(entry.RGBD_CAM, rcfg, "rgbd", *rin)
    torch.cuda.synchronize()
    r_launches = {"patch_gather": patches.PATCH_GATHER.launches,
                  "pose_opt": pose_opt_cuda.POSE_OPT.launches}
    _, routs_c = tracking._build_and_track_device(
        entry.RGBD_CAM, rcfg, "rgbd", *entry.scene_inputs(rscene, "cpu"))
    T_r = routs[5].cpu().numpy()
    t_err_r = float(np.abs(T_r[:3, 3] - rscene.T_true[:3, 3]).max())
    cpu_err_r = float(np.abs(T_r - routs_c[5].numpy()).max())
    n_r, n_rc = int(routs[6]), int(routs_c[6])
    print(f"[8] RGB-D 640x480: launches {r_launches}, {n_r} inliers of "
          f"{rscene.n_scene} scene points, depth on {int((rframe.depth > 0).sum())} "
          f"features, translation error {t_err_r:.3e} m; vs CPU |T - T_cpu| = "
          f"{cpu_err_r:.3e}, n_inliers {n_r} vs {n_rc}")
    _check(r_launches == {"patch_gather": 1, "pose_opt": 2}, f"RGB-D launches {r_launches}")
    _check(t_err_r < 1e-2, f"RGB-D translation error {t_err_r} m")
    _check(cpu_err_r <= 1e-4, f"RGB-D card vs CPU pose differs by {cpu_err_r}")
    _check(abs(n_r - n_rc) <= 0.01 * max(n_r, n_rc), f"RGB-D n_inliers {n_r} vs {n_rc}")

    # -- 9. KITTI timing -------------------------------------------------------
    # kernel 1's library yardstick: one advanced index into the
    # [H-37, W-37, 38, 38] unfold view per image, at corners computed
    # beforehand (the port never calls it)
    library_gathers = _unfold_gathers(frame_gathers)

    def library_frame():
        return [view[y0, x0] for view, y0, x0 in library_gathers]

    _check(torch.equal(torch.cat(library_frame()), torch.cat(
        [patches.extract_raw_patches_levels_plain(*g) for g in frame_gathers])),
        "the unfold indexing differs from the plain gather")
    gather_args = [patches.gather_launch_args(*g)[0] for g in frame_gathers]
    lm_launch, _ = pose_opt_cuda.pose_opt_launch_args(kcam, kouts[2], *lm_args)
    cam7, _, T0_7, X_7, obs_7 = entry.pose_problem(np.random.default_rng(SEED + 3), 7)
    args7 = (cam7, torch.from_numpy(T0_7).to(dev), torch.from_numpy(X_7).to(dev),
             torch.from_numpy(obs_7).to(dev), torch.ones(7, device=dev),
             torch.ones(7, dtype=torch.bool, device=dev))
    launch7, _ = pose_opt_cuda.pose_opt_launch_args(*args7)
    times_k = {
        "patch_gather": {
            "kernel_ms": _loop_ms(lambda: [patches.PATCH_GATHER(*a) for a in gather_args]),
            "call_ms": _loop_ms(lambda: [patches.extract_raw_patches_levels(*g)
                                         for g in frame_gathers]),
            "plain_ms": _loop_ms(lambda: [patches.extract_raw_patches_levels_plain(*g)
                                          for g in frame_gathers]),
            "library_ms": _loop_ms(library_frame),
        },
        "pose_opt": {
            "kernel_ms": _loop_ms(lambda: pose_opt_cuda.POSE_OPT(*lm_launch)),
            "call_ms": _loop_ms(lambda: pose_opt.pose_optimization(kcam, kouts[2], *lm_args)),
            "plain_ms": _loop_ms(
                lambda: pose_opt._pose_optimization_plain(kcam, kouts[2], *lm_args),
                n=5, warmup=1),
            "library_ms": None,
            "kernel_ms_O7": _loop_ms(lambda: pose_opt_cuda.POSE_OPT(*launch7)),
        },
    }
    bounds = {
        "patch_gather": _bound(sum(_gather_bytes(i, xy) for i, xy, _ in frame_gathers), 0),
        "pose_opt": _pose_bound(lm_args[0], lm_args[3]),
    }
    bound7 = _pose_bound(args7[2], args7[5])
    m_in, bm_in, img_a, img_b = kin[:4]
    track_args = (m_in, bm_in, kframe) + tuple(kin[5:])
    steps = {
        "build_frame_stereo": lambda: build_frame_stereo(
            img_a, img_b, 0.0, kcam, **kw),
        "_track_frame_device": lambda: tracking._track_frame_device(
            kcam, kcfg, *track_args),
        "track_frame_step": lambda: entry.track_frame_step(*kin),
    }
    step_ms = {}
    for name, fn in steps.items():
        ev = _cuda_ms(fn)
        t0 = time.perf_counter()
        for _ in range(N_TIMED):
            fn()
        torch.cuda.synchronize()
        step_ms[name] = (ev, (time.perf_counter() - t0) * 1e3 / N_TIMED)
        print(f"[9] {name}: {ev:.3f} ms/frame on CUDA events, "
              f"{step_ms[name][1]:.3f} ms/frame host wall ({card})")
    kitti_raw = []

    def kitti_orb(raw):
        kitti_raw.append(raw)
        return orb_from_patches(raw)
    with _in_place_of(extractor, "orb_from_patches", kitti_orb):
        steps["build_frame_stereo"]()
    brief_ab["kitti"] = _brief_ab({
        "orb_from_patches (N = " + " + ".join(str(r.shape[0]) for r in kitti_raw) + ")":
            lambda: [orb_from_patches(r) for r in kitti_raw],
        "build_frame_stereo": steps["build_frame_stereo"]}, "[9]", card)
    units = {"patch_gather": "the KITTI stereo frame's 3 launches",
             "pose_opt": f"one launch, the local-map problem at O = {lm_args[0].shape[0]}"}
    for name, t in times_k.items():
        b_ms, b_by = bounds[name]
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        print(f"[9] {name}: alone {t['kernel_ms']:.4f} ms, per call {t['call_ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, library {lib}; bound {b_ms:.5f} ms "
              f"({b_by}), {b_ms / t['kernel_ms']:.2%} of it alone ({units[name]}; {card})")
    print(f"[9] pose_opt at O = 7: alone {times_k['pose_opt']['kernel_ms_O7']:.4f} ms, "
          f"bound {bound7[0]:.6f} ms ({bound7[1]}): the floor of 40 dependent "
          f"iterations ({card})")

    # -- 10. keyframe insertion on the main path ---------------------------
    from orb_slam2_test_tpu_torch.slam_map.covisibility import build_observer_bitmap

    def counts():
        return {"patch_gather": patches.PATCH_GATHER.launches,
                "pose_opt": pose_opt_cuda.POSE_OPT.launches}

    def zero():
        patches.PATCH_GATHER.launches = 0
        pose_opt_cuda.POSE_OPT.launches = 0

    iscene = entry.kitti_insert_scene(np.random.default_rng(SEED + 1), dev)

    def insert_sequence(device):
        """track view 1 -> full insert -> track view 2 -> light insert,
        with the launch counts of each step."""
        m0 = entry.map_from_numpy(iscene.map, device)
        bm0 = build_observer_bitmap(m0)
        steps, launches = {}, {}
        zero()
        steps["track1"] = entry.track_insert_view(
            iscene, 1, m0, bm0, entry.frame_from_numpy(iscene.last_frame, device),
            torch.from_numpy(iscene.last_feat_pt).to(device),
            torch.zeros((), dtype=torch.int32, device=device))
        launches["track1"] = counts()
        f1, o1 = steps["track1"]
        zero()
        steps["full"] = entry.grow_map_step(
            m0, bm0, f1, o1[5], o1[7], 1.0, 1, iscene.close_depth, True)
        launches["full"] = counts()
        g1 = steps["full"]
        zero()
        steps["track2"] = entry.track_insert_view(iscene, 2, g1[0], g1[4], f1, o1[7], g1[1])
        launches["track2"] = counts()
        f2, o2 = steps["track2"]
        zero()
        steps["light"] = entry.grow_map_step(
            g1[0], g1[4], f2, o2[5], o2[7], 2.0, 2, iscene.close_depth, False)
        launches["light"] = counts()
        return (m0, bm0), steps, launches

    (m0, bm0), seq, ins_launches = insert_sequence(dev)
    torch.cuda.synchronize()
    print(f"[10] insert scene: {iscene.n_scene} points of view 0 in the bench map, "
          f"launches {ins_launches}")
    for step, want in (("track1", (3, 2)), ("full", (0, 0)), ("track2", (3, 2)),
                       ("light", (0, 0))):
        got = ins_launches[step]
        _check(got == dict(zip(("patch_gather", "pose_opt"), want)),
               f"{step} launches {got}")
    for i, step in ((1, "track1"), (2, "track2")):
        T = seq[step][1][5].cpu().numpy()
        err = float(np.abs(T[:3, 3] - iscene.T_true[i][:3, 3]).max())
        print(f"    {step}: {int(seq[step][1][6])} inliers, translation error {err:.3e} m")
        _check(err < 1e-2, f"{step} translation error {err} m")
    g1, g2 = seq["full"], seq["light"]
    n_before = int(iscene.map["n_pt"])
    created = int((g1[0].pt_valid & (g1[0].pt_first_kf == 1)).sum())
    print(f"    full insert: kf {int(g1[1])}, culled {int(g1[2])}, n_pt {n_before} -> "
          f"{int(g1[3])}, {created} points created (at most 100 from depth, so >= "
          f"{created - 100} triangulated); light insert: kf {int(g2[1])}, n_pt {int(g2[3])}")
    _check(created > 100, f"the full insert created {created} points: none triangulated")
    fresh = entry.map_from_numpy(iscene.map, dev)
    for name, a, b in zip(m0._fields, m0, fresh):
        _check(torch.equal(a, b), f"the inserts changed their input map: {name}")
    _check(torch.equal(bm0, build_observer_bitmap(fresh)), "the inserts changed their input bitmap")
    for name, g in (("full", g1), ("light", g2)):
        m = g[0]
        _check(int(m.n_kf) == int(m.kf_valid.sum()), f"{name}: n_kf != live keyframes")
        idx = m.kf_pt_idx[m.kf_valid]
        _check(bool(m.pt_valid[idx[idx >= 0].long()].all()), f"{name}: a link to a dead slot")
    _check(torch.equal(g1[4] > 0, build_observer_bitmap(g1[0]) > 0),
           "full insert's bitmap != build_observer_bitmap of its map")

    torch.cuda.set_sync_debug_mode("error")
    try:
        again = entry.grow_map_step(m0, bm0, seq["track1"][0], seq["track1"][1][5],
                                    seq["track1"][1][7], 1.0, 1, iscene.close_depth, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _check(int(again[1]) == int(g1[1]), "the insert under sync debug mode differs")
    print("    the full insert ran again under set_sync_debug_mode('error'): no host sync")

    def against(a, b):
        """(live poses' largest gap, the keyframe where it lies, share of
        equal links) between two inserts' maps."""
        A, B = entry.map_to_numpy(a[0]), entry.map_to_numpy(b[0])
        live = np.flatnonzero(A["kf_valid"])
        gaps = np.abs(A["kf_Tcw"][live] - B["kf_Tcw"][live]).reshape(len(live), -1).max(1)
        linked = (A["kf_pt_idx"] >= 0) | (B["kf_pt_idx"] >= 0)
        return (float(gaps.max()), int(live[gaps.argmax()]),
                float((A["kf_pt_idx"] == B["kf_pt_idx"])[linked].mean()))

    def on(x, device):
        return type(x)(*[t.to(device) for t in x])

    # each insert again from the card's own inputs: the gap that the
    # insertion program itself leaves between the two devices
    f1, o1 = seq["track1"]
    f2, o2 = seq["track2"]
    inputs = {"full": (m0, bm0, f1, o1[5], o1[7], 1.0, 1, iscene.close_depth, True),
              "light": (g1[0], g1[4], f2, o2[5], o2[7], 2.0, 2, iscene.close_depth, False)}

    def insert(name, device, dt=None):
        """The insert `name` from the card's inputs on `device`, with the
        tracked pose's translation moved by dt (m) if given."""
        m, bm, f, T, feat, *rest = inputs[name]
        T = T.to(device, copy=True)
        if dt is not None:
            T[:3, 3] += torch.tensor(dt, dtype=T.dtype, device=T.device)
        return entry.grow_map_step(on(m, device), bm.to(device), on(f, device), T,
                                   feat.to(device), *rest)

    same = {name: insert(name, "cpu") for name in inputs}
    # the light insert's spread under rounding: the same insert from the
    # tracked pose moved by 1e-6 m along x, y and z, on the card and on
    # the CPU (the JAX package's light insert moves as much; PERF.md)
    spread = {}
    for device, base in (("cuda", g2), ("cpu", same["light"])):
        outs = [base] + [insert("light", device, 1e-6 * (np.arange(3) == i)) for i in range(3)]
        spread[device] = max(against(a, b)[0] for i, a in enumerate(outs) for b in outs[i + 1:])
    repeat_gap = against(g2, insert("light", "cuda"))[0]
    print(f"    light insert from the tracked pose moved by 1e-6 m along x, y, z: live "
          f"poses spread {spread['cuda']:.3e} on the card, {spread['cpu']:.3e} on the CPU; "
          f"the card's light insert repeated: {repeat_gap:.3e}")
    _, cseq, _ = insert_sequence("cpu")
    same_gap = {}
    for name in ("full", "light"):
        a, b, s = seq[name], cseq[name], same[name]
        kf_err, kf_at, links = against(a, b)
        same_gap[name], same_at, same_links = against(a, s)
        # the scene's keyframes 200 and 201 are views 1 and 2
        live = a[0].kf_valid.cpu().numpy()
        Tk = a[0].kf_Tcw.cpu().numpy()
        truth = {kf: float(np.abs(Tk[kf][:3, 3] - iscene.T_true[v][:3, 3]).max())
                 for kf, v in ((int(g1[1]), 1), (int(g2[1]), 2)) if live[kf]}
        print(f"    {name} vs CPU: kf {int(a[1])}/{int(b[1])}, culled {int(a[2])}/{int(b[2])}, "
              f"n_pt {int(a[3])}/{int(b[3])}, live poses within {kf_err:.3e} (kf {kf_at}), "
              f"links equal {links:.5f}; from the card's inputs: n_pt {int(s[3])}, "
              f"live poses within {same_gap[name]:.3e} (kf {same_at}), links equal "
              f"{same_links:.5f}; keyframes from the truth (m): "
              + ", ".join(f"{kf} {e:.3e}" for kf, e in truth.items()))
        _check(int(a[1]) == int(b[1]) and int(a[2]) == int(b[2]), f"{name}: kf ids vs CPU")
        _check(abs(int(a[3]) - int(b[3])) <= 0.01 * int(b[3]), f"{name}: n_pt vs CPU")
        _check(links >= 0.99, f"{name}: links equal {links}")
        _check(int(s[1]) == int(a[1]) and int(s[2]) == int(a[2]),
               f"{name}: kf ids differ from the CPU on the same inputs")
        _check(abs(int(s[3]) - int(a[3])) <= 1e-3 * int(a[3]),
               f"{name}: n_pt {int(a[3])} vs {int(s[3])} on the CPU on the same inputs")
        _check(same_links >= 0.999, f"{name}: links equal {same_links} on the same inputs")
        _check(max(truth.values()) < 1e-2, f"{name}: keyframes from the truth {truth}")
        atol, same_atol = INSERT_POSE_ATOL[name]
        _check(kf_err <= atol, f"{name}: poses differ from the CPU by {kf_err}")
        _check(same_gap[name] <= same_atol,
               f"{name}: poses differ from the CPU on the same inputs by {same_gap[name]}")

    # -- 11. insertion timing at the bench's inputs -------------------------
    bmap = entry.map_from_numpy(entry.bench_map(kcfg, entry.KITTI_N_KF, entry.KITTI_N_PT), dev)
    bbm = build_observer_bitmap(bmap)
    brng = np.random.default_rng(0)  # bench.py's mk_args(0)
    bl = torch.tensor(brng.uniform(0, 255, (kcam.height, kcam.width)), dtype=torch.float32)
    br = torch.tensor(brng.uniform(0, 255, (kcam.height, kcam.width)), dtype=torch.float32)
    bfeat = torch.tensor(brng.integers(-1, 40000, kcfg.n_features), dtype=torch.int32).to(dev)
    bframe = build_frame_stereo(bl.to(dev), br.to(dev), 0.0, kcam, **kw)
    bcd = kcfg.th_depth * kcam.baseline
    eye = torch.eye(4, device=dev)
    insert_ms = {}
    grows = {name: (lambda rebuild=rebuild: entry.grow_map_step(
        bmap, bbm, bframe, eye, bfeat, 0.0, 99, bcd, rebuild))
        for name, rebuild in (("full", True), ("light", False))}
    for grow in grows.values():
        for _ in range(3):
            grow()
    # full and light in turns, so that the host's load falls on both alike
    times = {name: ([], []) for name in grows}
    for _ in range(20):
        for name, grow in grows.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            grow()
            end.record()
            end.synchronize()
            times[name][1].append((time.perf_counter() - t0) * 1e3)
            times[name][0].append(start.elapsed_time(end))
    for name, (ev, wall) in times.items():
        insert_ms[name] = (statistics.median(ev), statistics.median(wall))
        print(f"[11] {name} insert: {insert_ms[name][0]:.3f} ms on CUDA events, "
              f"{insert_ms[name][1]:.3f} ms host wall ({card})")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "runs", "kitti00_full", "summary.json")) as f:
        summary = json.load(f)
    kf_every = summary["frames"] / summary["keyframes"]
    R = kcfg.bm_rebuild_every
    amortized = {
        i: step_ms["track_frame_step"][i]
        + (insert_ms["full"][i] + (R - 1) * insert_ms["light"][i]) / R / kf_every
        for i in (0, 1)
    }
    print(f"[11] amortized KITTI: {amortized[0]:.3f} ms/frame on CUDA events, "
          f"{amortized[1]:.3f} ms/frame host wall (track_frame_step + (full + "
          f"{R - 1} light) / {R} / {kf_every:.4f}; {card})")
    seq_stats = _kitti_sequence_phase(dev, card)
    # [11]'s formula with the port's own cadence in place of the JAX run's
    port_every = seq_stats["cadence_frames_per_kf"]
    amortized_port = {
        i: step_ms["track_frame_step"][i]
        + (insert_ms["full"][i] + (R - 1) * insert_ms["light"][i]) / R / port_every
        for i in (0, 1)
    }
    print(f"[11] amortized KITTI with the port's cadence from [12], {port_every:.4f} frames "
          f"per keyframe (the JAX run's: {kf_every:.4f}): {amortized_port[0]:.3f} ms/frame "
          f"on CUDA events, {amortized_port[1]:.3f} ms/frame host wall ({card})")
    mono_stats = _tum_mono_phase(dev, card)
    reloc_stats = _relocalization_phase(dev, card)
    oab_stats = _out_and_back_phase(dev, card)
    loop_stats = _kitti_loop_phase(dev, card)
    print(f"[15] phases 1-15 took {time.perf_counter() - t_run:.1f} s, the kernels' build "
          "included")
    par = _parallel_phase(dev, card)
    print(f"[16] phases 1-16 took {time.perf_counter() - t_run:.1f} s, the kernels' build "
          "included")
    # [18] reads [15b]'s ring from memory, and runs before [17]: a
    # process that has traced the card runs slower afterwards
    tools_stats = _offline_tools_phase(dev, card, loop_stats.pop("ring"))
    print(f"[18] phases 1-16 and 18 took {time.perf_counter() - t_run:.1f} s, the kernels' "
          "build included")
    drivers_stats = _dataset_drivers_phase(dev, card)
    print(f"[19] phases 1-16, 18 and 19 took {time.perf_counter() - t_run:.1f} s, the "
          "kernels' build included")
    large_stats = _large_map_phase(dev, card, loop_stats)
    print(f"[20] phases 1-16 and 18-20 took {time.perf_counter() - t_run:.1f} s, the "
          f"kernels' build included")
    live_stats = _kitti_live_phase(dev, card)
    print(f"[17] phases 1-20 took {time.perf_counter() - t_run:.1f} s, the kernels' build "
          f"included")
    large_stats["correction_profile"] = _large_map_profile(dev, card,
                                                           large_stats.pop("profile_inputs"))
    run_s = time.perf_counter() - t_run
    print(f"[20] the profile done: all phases took {run_s:.1f} s, the kernels' build included")

    kernels = []
    for name, source, replaces, err in (
        ("patch_gather", "orb_slam2_test_tpu_torch/csrc/patches.cu",
         "orb_slam2_test_tpu/ops/patches.py:61", patch_err),
        ("pose_opt", "orb_slam2_test_tpu_torch/csrc/pose_opt.cu",
         "orb_slam2_test_tpu/solvers/pose_opt_pallas.py:107", pose_err),
    ):
        t = times_k[name]
        # `launches` and `ms` are the line's standard keys; the same
        # numbers also stand under the names this port's PERF.md reads,
        # `launches_per_frame` and `kernel_ms` (see "aliases")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": k_launches[name], "launches_per_frame": k_launches[name],
            "max_abs_err": err, "ms": t["kernel_ms"], **t,
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "timed_on": units[name],
        })
    print(json.dumps({
        "kernels": kernels,
        "aliases": {"launches_per_frame": "launches: the KITTI stereo frame's count",
                    "kernel_ms": "ms: the kernel alone"},
        "launches_by_path": {"mono_tracking_step": launches,
                             "kitti_stereo": k_launches, "rgbd": r_launches,
                             "kitti_insert_sequence": ins_launches,
                             "kitti_sequence": seq_stats["launches"],
                             "tum_mono_sequence": mono_stats["launches"],
                             "kitti_relocalization": reloc_stats["launches"],
                             "out_and_back": oab_stats["launches"],
                             "kitti_loop": loop_stats["launches"],
                             "dryrun_multichip": par["dryrun"]["launches"],
                             "kitti_multi_seq": par["multi_seq"]["launches"],
                             "kitti_live": live_stats["launches"],
                             "build_vocab": tools_stats["build_vocab"]["launches"],
                             "vocab_recall": tools_stats["vocab_recall"]["launches"],
                             "ba_window_sweep": tools_stats["ba_window_sweep"]["launches"],
                             **{f"dataset_{k}": v["launches"]
                                for k, v in drivers_stats["runs"].items()},
                             "dataset_mono_tum_full": drivers_stats["mono_tum_full"]["launches"],
                             "large_map": large_stats["launches"]},
        "tracking_step_ms": step_ms_mono,
        "brief_gather_vs_allbin_product_ms": brief_ab,
        "tracking_step_wall_ms": step_wall_ms,
        "kitti_stereo_ms": {k: v[0] for k, v in step_ms.items()},
        "kitti_stereo_wall_ms": {k: v[1] for k, v in step_ms.items()},
        "kf_insert_ms": {k: v[0] for k, v in insert_ms.items()},
        "kf_insert_wall_ms": {k: v[1] for k, v in insert_ms.items()},
        "kitti_amortized_ms_per_frame": amortized[0],
        "kitti_amortized_wall_ms_per_frame": amortized[1],
        "kf_every": kf_every,
        "kitti_amortized_port_cadence_ms_per_frame": amortized_port[0],
        "kitti_amortized_port_cadence_wall_ms_per_frame": amortized_port[1],
        "kitti_sequence": {k: v for k, v in seq_stats.items() if k != "launches"},
        "tum_mono_sequence": {k: v for k, v in mono_stats.items() if k != "launches"},
        "kitti_relocalization": {k: v for k, v in reloc_stats.items() if k != "launches"},
        "out_and_back": {k: v for k, v in oab_stats.items() if k != "launches"},
        "kitti_loop": {k: v for k, v in loop_stats.items() if k != "launches"},
        "dist_ba": par["dist_ba"],
        "kitti_multi_seq": {k: v for k, v in par["multi_seq"].items() if k != "launches"},
        "two_ranks": par["two_ranks"],
        "kitti_live": {k: v for k, v in live_stats.items() if k != "launches"},
        "offline_tools": tools_stats,
        "dataset_drivers": drivers_stats,
        "large_map": {k: v for k, v in large_stats.items() if k != "launches"},
        "light_insert_pose_spread_per_1e-6_m": spread,
        "insert_pose_gap_vs_cpu_same_inputs": same_gap,
        "light_insert_repeat_gap": repeat_gap,
        "run_s": run_s,
    }))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--joint-ba-rank"]:
        sys.exit(_joint_ba_rank(sys.argv[2:]))
    sys.exit(main())
