"""orb_slam2_test_tpu_torch — the SLAM engine on PyTorch and CUDA.

A port of `orb_slam2_test_tpu` (JAX/XLA/Pallas) to PyTorch, with the
two Pallas kernels rewritten by hand in CUDA C++ for Hopper (sm_90a).
Subpackages and modules keep the JAX package's names so that each
counterpart is easy to find; public functions keep its layouts and
dtypes, except that packed descriptors are int32 bit patterns [N, 8]
(torch has no uint32 shifts).

Layout:
  geometry/   pinhole camera, SE3, Sim3, robust-loss constants,
              triangulation
  ops/        pyramid, FAST, BRIEF, patch gather (CUDA kernel 1),
              ORB extraction, stereo matching, Hamming matching
  engine/     frames, matchers, the per-frame and keyframe-insertion
              programs and the host Tracker, local mapping,
              relocalization, loop closing
  slam_map/   the map state, covisibility, maintenance, the keyframe
              database
  solvers/    motion-only BA (CUDA kernel 2), local and global BA,
              initialization, PnP, Sim3, the pose graph
  bow/        the BoW vocabulary (transform, build, DBoW2 text)
  parallel/   the distributed BA, multiple maps, multi-process set-up
  io/         settings, datasets, live sources, trajectories,
              checkpoints
  evaluation/ ATE / RPE
  viz/        the PNG snapshot viewer, the HTTP live viewer, frame and
              map drawers, the AR overlay
  utils/      nvcc + ctypes builder, precision flags, the stage
              profiler, synthetic scenes
  csrc/       CUDA C++ sources, built at first use into _build/
  system.py   the System facade; cli.py the command-line driver
  entry.py    the paths chip_smoke.py drives and their scenes

Every function takes tensors on one device. A CPU tensor runs the
plain PyTorch version of each kernel; a CUDA tensor launches the
hand-written kernel or raises. The package never imports JAX.
"""

__version__ = "0.1.0"
