"""ctypes bindings for the C++ sequence loader (native/npz_loader.cpp): the
port's own copy of caspr_tpu/data/native_loader.py.

The twin of ``dataset.load_seq_path`` with identical output: the zip and
npy parsing and the sequence assembly run in C++, a thread per frame
group, off the interpreter lock.  It compiles the source with g++ at first
use into the port's build directory ``caspr_tpu_torch/_build/``, under a
name that carries a hash of the source, so a library built for another
version of the source, or checked in from another machine, is never
loaded.  Without g++ or zlib it prints one warning and
``load_seq_path_native`` takes the numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Sequence

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "npz_loader.cpp")
_BUILD_DIR = os.path.join(_PKG, "_build")

_lock = threading.Lock()
_lib = None
_lib_failed = False


def _load_native():
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            with open(_SRC, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()[:16]
            lib_path = os.path.join(_BUILD_DIR, f"libcaspr_npz_{digest}.so")
            if not os.path.exists(lib_path):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                tmp = f"{lib_path}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
                     _SRC, "-o", tmp, "-lz", "-lpthread"],
                    check=True, capture_output=True)
                os.replace(tmp, lib_path)
            lib = ctypes.CDLL(lib_path)
            lib.caspr_load_sequence.restype = ctypes.c_int
            lib.caspr_load_sequence.argtypes = [
                ctypes.c_char_p,
                ctypes.c_int,
                ctypes.c_int64,
                ctypes.c_double,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
            ]
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as exc:  # no toolchain: numpy
            print(f"WARNING: native npz loader unavailable ({exc}); using numpy")
            _lib_failed = True
        return _lib


def native_available() -> bool:
    return _load_native() is not None


def load_seq_path_native(seq_path_list: Sequence[str], max_timestamp: float = 5.0,
                         expected_num_pts: int = 4096, num_threads: int = 2):
    """The native twin of ``dataset.load_seq_path``: (nocs (T, N, 4), depth
    (T, N, 4), pose (T, 4, 4)), float64."""
    lib = _load_native()
    if lib is None:
        from .dataset import load_seq_path

        return load_seq_path(seq_path_list, max_timestamp, expected_num_pts)

    t = len(seq_path_list)
    nocs = np.zeros((t, expected_num_pts, 4), np.float64)
    depth = np.zeros((t, expected_num_pts, 4), np.float64)
    pose = np.zeros((t, 4, 4), np.float64)
    paths_blob = b"".join(os.fsencode(p) + b"\x00" for p in seq_path_list)
    as_ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    rc = lib.caspr_load_sequence(paths_blob, t, expected_num_pts, max_timestamp, num_threads,
                                 as_ptr(nocs), as_ptr(depth), as_ptr(pose))
    if rc < 0:
        raise IOError(f"native loader failed on frame {-rc - 1} of sequence")
    return nocs, depth, pose
