"""Rigid-registration RANSAC on the host: ctypes bindings for the native
C++ module (native/ransac.cpp) with a vectorized numpy version for hosts
without a C++ compiler.

The port's own copy of caspr_tpu/utils/ransac.py (numpy and ctypes only).
It compiles the same source with g++ at first use, into the port's build
directory ``caspr_tpu_torch/_build/`` under a name that carries a hash of
the source, so a library built for another version of the source, or
checked in from another machine, is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "ransac.cpp")
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
            lib_path = os.path.join(_BUILD_DIR, f"libcaspr_ransac_{digest}.so")
            if not os.path.exists(lib_path):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                tmp = f"{lib_path}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
                     _SRC, "-o", tmp],
                    check=True, capture_output=True)
                os.replace(tmp, lib_path)
            lib = ctypes.CDLL(lib_path)
            lib.ransac_registration.restype = ctypes.c_int
            lib.ransac_registration.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int,
                ctypes.c_double,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_double),
            ]
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as exc:  # no toolchain: numpy
            print(f"WARNING: native RANSAC unavailable ({exc}); using numpy")
            _lib_failed = True
        return _lib


def kabsch_umeyama(src: np.ndarray, dst: np.ndarray):
    """Rigid (R, t) minimizing ||R src + t - dst||^2 (point-to-point,
    no scaling — TransformationEstimationPointToPoint(False))."""
    cs = src.mean(axis=0)
    cd = dst.mean(axis=0)
    h = (src - cs).T @ (dst - cd)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    dmat = np.diag([1.0, 1.0, d])
    r = vt.T @ dmat @ u.T
    t = cd - r @ cs
    return r, t


def _ransac_numpy(
    src, dst, max_corr_dist, ransac_n, max_iteration, max_validation, seed
):
    """Vectorized fallback: batch-Kabsch all candidate samples at once,
    then evaluate inliers in chunks."""
    n = src.shape[0]
    rng = np.random.default_rng(seed)
    k = min(max_iteration, max_validation)
    sel = rng.integers(0, n, size=(k, ransac_n))
    s = src[sel]  # (K, rn, 3)
    d = dst[sel]
    cs = s.mean(axis=1, keepdims=True)
    cd = d.mean(axis=1, keepdims=True)
    h = np.einsum("kni,knj->kij", s - cs, d - cd)
    u, _, vt = np.linalg.svd(h)
    det = np.linalg.det(np.einsum("kij,klj->kil", vt.transpose(0, 2, 1), u))
    dmat = np.tile(np.eye(3), (k, 1, 1))
    dmat[:, 2, 2] = np.sign(det)
    r = np.einsum("kji,kjl,kml->kim", vt, dmat, u)  # V D U^T
    t = cd[:, 0, :] - np.einsum("kij,kj->ki", r, cs[:, 0, :])

    thresh2 = max_corr_dist * max_corr_dist
    best = (-1.0, np.inf, 0)
    best_rt = (np.eye(3), np.zeros(3))
    chunk = max(1, int(2e7) // n)
    for lo in range(0, k, chunk):
        hi = min(k, lo + chunk)
        pred = np.einsum("kij,nj->kni", r[lo:hi], src) + t[lo:hi, None, :]
        d2 = np.sum((pred - dst[None]) ** 2, axis=-1)  # (C, N)
        inl = d2 < thresh2
        counts = inl.sum(axis=1)
        err = np.where(inl, d2, 0.0).sum(axis=1)
        for ci in range(hi - lo):
            c = int(counts[ci])
            fitness = c / n
            rmse = np.sqrt(err[ci] / c) if c > 0 else np.inf
            if fitness > best[0] or (fitness == best[0] and rmse < best[1]):
                best = (fitness, rmse, c)
                best_rt = (r[lo + ci], t[lo + ci])
    out = np.eye(4)
    out[:3, :3] = best_rt[0]
    out[:3, 3] = best_rt[1]
    return out


def ransac_rigid_registration(
    source: np.ndarray,
    target: np.ndarray,
    max_corr_dist: float = 0.015,
    ransac_n: int = 4,
    max_iteration: int = 50000,
    max_validation: int = 5000,
    seed: int = 0,
):
    """Estimate the rigid transform mapping source -> target given identity
    correspondences.  Returns a 4x4 transform (numpy float64)."""
    src = np.ascontiguousarray(source, dtype=np.float64)
    dst = np.ascontiguousarray(target, dtype=np.float64)
    lib = _load_native()
    if lib is None:
        return _ransac_numpy(
            src, dst, max_corr_dist, ransac_n, max_iteration, max_validation, seed
        )
    out = np.zeros((4, 4), dtype=np.float64)
    rc = lib.ransac_registration(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        src.shape[0],
        max_corr_dist,
        ransac_n,
        max_iteration,
        max_validation,
        ctypes.c_uint64(seed),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc < 0:
        raise ValueError("ransac_registration failed (too few points?)")
    return out
