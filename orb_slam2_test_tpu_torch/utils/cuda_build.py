"""Build the CUDA kernels with nvcc and bind them with ctypes.

All sources under csrc/ are compiled for Hopper (sm_90a) into one
shared library with a plain C interface, at first use, into
orb_slam2_test_tpu_torch/_build/. The library's name carries a hash of
the sources, so an edit to any of them triggers a rebuild. Nothing is
compiled or loaded when a module is imported.

Each C entry point launches one kernel on the stream it is given and
returns cudaGetLastError(); `CudaKernel` binds its entry point once,
raises when that code is not 0, and counts the launches that
succeeded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _source_hash(csrc: Path, flags: tuple[str, ...]) -> str:
    h = hashlib.sha256()
    for p in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME/bin (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin "
        f"(CUDA_HOME={home}); the CUDA kernels cannot be built"
    )


class BuildInfo(NamedTuple):
    """What the build did: library path, nvcc seconds, compiler output,
    and whether a library for the same sources already existed."""

    path: Path
    seconds: float
    log: str
    cached: bool


def build_library(csrc: Path = CSRC, extra_flags: tuple[str, ...] = ()) -> BuildInfo:
    """Compile csrc/*.cu into _build/libslam_kernels_<hash>.so unless a
    library for the same sources and flags exists. Raises with the
    compiler's output if nvcc is missing or fails. `csrc` and
    `extra_flags` (for example a -D switch) serve measurement scripts;
    the package loads the default build."""
    flags = NVCC_FLAGS + tuple(extra_flags)
    out = BUILD_DIR / f"libslam_kernels_{_source_hash(csrc, flags)}.so"
    if out.is_file():
        return BuildInfo(out, 0.0, "", cached=True)
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *flags, "-o", tmp, *map(str, sorted(csrc.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return BuildInfo(out, seconds, log, cached=False)


@functools.lru_cache(maxsize=None)
def load_library() -> tuple[ctypes.CDLL, BuildInfo]:
    """Build (if needed) and load the kernel library, once per process."""
    info = build_library()
    lib = ctypes.CDLL(str(info.path))
    lib.slam_kernels_error_string.argtypes = [ctypes.c_int]
    lib.slam_kernels_error_string.restype = ctypes.c_char_p
    return lib, info


class CudaKernel:
    """One C entry point of the kernel library, with a launch counter.

    `launches` counts the successful launches made through this object
    and nothing else; a caller may reset it to 0.
    """

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:  # bind once: argtypes and restype stay set
            lib, _ = load_library()
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            msg = load_library()[0].slam_kernels_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} ({msg})")
        self.launches += 1

    def launch(self, device: torch.device, *args) -> None:
        """Call the entry point with `device` current; the device switch
        is made only when another device is current."""
        if device.index is None or device.index == torch.cuda.current_device():
            self(*args)
        else:
            with torch.cuda.device(device):
                self(*args)


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on `device`, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
