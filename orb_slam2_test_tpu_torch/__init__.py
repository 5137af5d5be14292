"""orb_slam2_test_tpu_torch — the SLAM engine on PyTorch and CUDA.

A port of `orb_slam2_test_tpu` (JAX/XLA/Pallas) to PyTorch, with the
two Pallas kernels rewritten by hand in CUDA C++ for Hopper (sm_90a).
Subpackages and modules keep the JAX package's names so that each
counterpart is easy to find; public functions keep its layouts and
dtypes, except that packed descriptors are int32 bit patterns [N, 8]
(torch has no uint32 shifts).

Layout:
  geometry/   pinhole camera, SE3, robust-loss constants
  ops/        pyramid, FAST, BRIEF, patch gather (CUDA kernel 1),
              ORB extraction, Hamming matching
  engine/     frame construction, projection matching
  solvers/    reprojection residuals, motion-only BA (CUDA kernel 2)
  utils/      nvcc + ctypes builder, precision flags
  csrc/       CUDA C++ sources, built at first use into _build/
  entry.py    the per-frame tracking step and its test scenes

Every function takes tensors on one device. A CPU tensor runs the
plain PyTorch version of each kernel; a CUDA tensor launches the
hand-written kernel or raises. The package never imports JAX.
"""

__version__ = "0.1.0"
