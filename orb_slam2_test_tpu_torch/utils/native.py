"""Runtime build + load of the native C++ host helpers.

Port of orb_slam2_test_tpu/utils/native.py. The host-side pieces that
are CPU-bound (the DBoW2 vocabulary text parse, a ~145 MB file for the
reference's ORBvoc.txt) are C++ under native/, compiled with g++ at
first use into orb_slam2_test_tpu_torch/_build/ and loaded through
ctypes. Every native entry point has a pure-Python fallback, so a
missing compiler makes the parse slower, not wrong. Nothing is built
when a module is imported.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG / "native"
BUILD_DIR = _PKG / "_build"

_lock = threading.Lock()
_cache: dict[str, ctypes.CDLL | None] = {}


def load_native(name: str) -> ctypes.CDLL | None:
    """Build (if missing or older than its source) and dlopen
    native/<name>.cc. Returns None when g++ is missing or the build
    fails; callers fall back to their Python implementation. The library
    is written under a temporary name and renamed into place, so
    processes that build at once never load a half-written file."""
    with _lock:
        if name in _cache:
            return _cache[name]
        src = _SRC_DIR / f"{name}.cc"
        lib = BUILD_DIR / f"lib{name}.so"
        try:
            if not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                try:
                    subprocess.run(
                        ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, str(src)],
                        check=True, capture_output=True, timeout=120,
                    )
                    os.replace(tmp, lib)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            _cache[name] = ctypes.CDLL(str(lib))
        except (OSError, subprocess.SubprocessError):
            _cache[name] = None
        return _cache[name]


class _VocabData(ctypes.Structure):
    _fields_ = [
        ("n_nodes", ctypes.c_int64),
        ("k", ctypes.c_int32),
        ("depth", ctypes.c_int32),
        ("desc", ctypes.POINTER(ctypes.c_uint8)),
        ("parent", ctypes.POINTER(ctypes.c_int32)),
        ("is_leaf", ctypes.POINTER(ctypes.c_uint8)),
        ("weight", ctypes.POINTER(ctypes.c_float)),
    ]


def parse_vocab_text(path: str):
    """C++ DBoW2 text parse. Returns (k, depth, desc_bytes [n, 32] u8,
    parent [n] i32, is_leaf [n] bool, weight [n] f32) with node 0 =
    root, or None if the native library is unavailable or the file is
    malformed."""
    lib = load_native("vocab_loader")
    if lib is None:
        return None
    lib.vocab_load_text.restype = ctypes.POINTER(_VocabData)
    lib.vocab_load_text.argtypes = [ctypes.c_char_p]
    lib.vocab_free.restype = None
    lib.vocab_free.argtypes = [ctypes.POINTER(_VocabData)]

    h = lib.vocab_load_text(os.fsencode(path))
    if not h:
        return None
    try:
        v = h.contents
        n = int(v.n_nodes)
        desc = np.ctypeslib.as_array(v.desc, (n, 32)).copy()
        parent = np.ctypeslib.as_array(v.parent, (n,)).copy()
        is_leaf = np.ctypeslib.as_array(v.is_leaf, (n,)).copy().astype(bool)
        weight = np.ctypeslib.as_array(v.weight, (n,)).copy()
        return int(v.k), int(v.depth), desc, parent, is_leaf, weight
    finally:
        lib.vocab_free(h)
