"""The port's hand-written CUDA kernels: build, ctypes binding, dispatch.

Ten kernels, one per TPU kernel of the reconstruct, evaluation and
training paths (sources and design notes in ``caspr_tpu_torch/csrc/*.cu``):

  fps                -> farthest_point_sampling
  ball_query         -> ball_query / ball_query_pair
  gather             -> gather_points
  three_nn           -> three_nn
  three_interpolate  -> three_interpolate
  cnf_primal         -> cnf_primal (the decode dynamics; tensor cores,
                        3xTF32: csrc/cnf_tc.cuh; with matmul_dtype="bf16"
                        its one-pass bfloat16 variant, counted as
                        cnf_primal_bf16)
  cnf_dynamics       -> cnf_dynamics (the likelihood dynamics, with the
                        Hutchinson divergence; the same layer tile, and
                        its bfloat16 variant, counted as cnf_dynamics_bf16)
  cnf_dynamics_vjp   -> cnf_dynamics_vjp (its VJP: the adjoint's augmented
                        dynamics in training; the same layer tile, and a
                        3xTF32 split-K product for the weight gradients;
                        with matmul_dtype="bf16" its one-pass bfloat16
                        variant, counted as cnf_dynamics_vjp_bf16)
  emd                -> approx_match_emd (the approxmatch EMD cost; a
                        thread-block cluster per cloud pair)
  sa_fused           -> sa_fused (one set-abstraction scale after the
                        factored conv1: gather, GroupNorms, conv2, conv3,
                        max over the ball)

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, and then takes one of two routes by the device of its inputs: a
CPU tensor goes to the plain PyTorch version (``ops/pointops.py``,
``ops/cnf_fused.py::primal_packed``, ``dynamics_packed`` and
``dynamics_vjp_packed`` (in the ``matmul_dtype`` asked for),
``ops/emd_plain.py::emd_plain``, ``ops/sa_fused.py::sa_stack_plain``); a CUDA tensor launches the kernel on
the current stream, raises if the launch fails, and adds one to
``launches[name]``.  There is no fallback from the card to the plain
version.  ``approx_match_emd_float64`` runs the emd kernel's body in
float64, for checking it; it is on no path and counts as no launch.

The library is compiled at first use with nvcc (one process per source,
all started together, then one link) into ``caspr_tpu_torch/_build/``,
named by a hash of the sources and flags, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from . import pointops
from .cnf_fused import (KERNEL_HIDDEN_LAYERS, KERNEL_MAX_DIM, KERNEL_MAX_WIDTH, KERNEL_WIDTH_STEP,
                        check_matmul_dtype, dynamics_packed, dynamics_vjp_packed, primal_packed)
from .emd_plain import emd_plain
from .sa_fused import MAX_K, MAX_WIDTH, NUM_GROUPS, sa_stack_plain

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = (
    "fps.cu",
    "ball_query.cu",
    "gather.cu",
    "three_nn.cu",
    "three_interpolate.cu",
    "cnf_primal.cu",
    "cnf_dynamics.cu",
    "cnf_dynamics_vjp.cu",
    "emd.cu",
    "sa_fused.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

KERNELS = ("fps", "ball_query", "gather", "three_nn", "three_interpolate",
           "cnf_primal", "cnf_dynamics", "cnf_dynamics_vjp", "emd", "sa_fused")
# the one-pass bfloat16 variants of the three CNF kernels (the same
# sources, csrc/cnf_primal.cu, cnf_dynamics.cu and cnf_dynamics_vjp.cu),
# counted apart
VARIANTS = ("cnf_primal_bf16", "cnf_dynamics_bf16", "cnf_dynamics_vjp_bf16")
FPS_SHARED_POINTS = 8192  # N up to which the fps kernel holds a cloud in registers
GATHER_MAX_FLOATS = 2**31 - 1  # R * C and N * C of one batch of the gather kernel
# Launches of each kernel since the last reset_launches(); bumped only where
# a kernel is launched on the card.
launches = dict.fromkeys(KERNELS + VARIANTS, 0)

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {  # every entry takes the stream last and returns a cudaError_t
    "caspr_fps": [_P, _P, _P, _I, _I, _I, _P],
    "caspr_ball_query_pair": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _F, _I, _P],
    "caspr_gather_rows": [_P, _P, _P, _I, _I, _I, _LL, _P],
    "caspr_three_nn": [_P, _P, _P, _P, _I, _I, _I, _P],
    "caspr_three_interpolate": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "caspr_cnf_primal": [_P] * 7 + [_I] * 6 + [_P],
    "caspr_cnf_primal_bf16": [_P] * 7 + [_I] * 6 + [_P],
    "caspr_cnf_dynamics": [_P] * 9 + [_I] * 6 + [_P],
    "caspr_cnf_dynamics_bf16": [_P] * 9 + [_I] * 6 + [_P],
    "caspr_cnf_dynamics_vjp": [_P] * 13 + [_I] * 6 + [_P],
    "caspr_cnf_dynamics_vjp_bf16": [_P] * 13 + [_I] * 6 + [_P],
    "caspr_approx_match_emd": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "caspr_approx_match_emd_f64": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "caspr_sa_fused": [_P] * 14 + [_I] * 7 + [_P],
}
_lib = None
_lib_lock = threading.Lock()


def reset_launches():
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the kernels build only where the CUDA toolkit is installed")


def _library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    return BUILD_DIR / f"libcaspr_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/ into one shared library (if this version of the
    sources has not been built yet) and return its path.  ptxas's register
    and spill report of each source lands in ``_build/<source>.log``."""
    lib_path = _library_path()
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    objs, procs = [], []
    try:
        for name in SOURCES:
            obj = BUILD_DIR / f"{name}.{tag}.o"
            log = open(BUILD_DIR / f"{name}.log", "w")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
            objs.append(obj)
    finally:
        failed = []
        for name, log, proc in procs:
            if proc.wait() != 0:
                failed.append(name)
            log.close()
    if failed:
        logs = "\n".join((BUILD_DIR / f"{n}.log").read_text() for n in failed)
        raise RuntimeError(f"nvcc failed on {failed}:\n{logs}")
    tmp = BUILD_DIR / f"{lib_path.name}.{tag}.tmp"
    subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                   check=True, capture_output=True)
    os.replace(tmp, lib_path)
    for obj in objs:
        obj.unlink()
    return lib_path


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            for name in ("caspr_cnf_dynamics_vjp_workspace",
                         "caspr_cnf_dynamics_vjp_bf16_workspace"):
                fn = getattr(lib, name)
                fn.argtypes = [_I] * 5
                fn.restype = _LL
            for name, count in (("caspr_emd_cluster_size", 3), ("caspr_three_nn_split", 2),
                                ("caspr_sa_fused_instance", 4)):
                fn = getattr(lib, name)
                fn.argtypes = [_I] * count
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _launch(kernel, entry: str, device, *args):
    """Launch ``entry`` on the current stream of ``device`` and count it as
    a launch of ``kernel`` (None: the float64 form of one, counted nowhere)."""
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: launch failed with cudaError_t {err}")
    if kernel is not None:
        launches[kernel] += 1


def _check(name, t, dtype, ndim, last=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if last is not None and t.shape[-1] != last:
        raise ValueError(f"{name}: expected last dim {last}, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_shape(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} {tuple(t.shape)}, expected {tuple(shape)}")


def _on_card(*tensors) -> bool:
    """False for CPU inputs, True for CUDA inputs; raises on a mix or on
    any other device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {kind!r}")
    return kind == "cuda"


def _same_batch(*tensors):
    if len({t.shape[0] for t in tensors}) != 1:
        raise ValueError(f"batch sizes differ: {[tuple(t.shape) for t in tensors]}")


# ------------------------------- wrappers ---------------------------------


def farthest_point_sampling(xyz, num_samples: int):
    """xyz (B, N, 3) float32 -> (B, M) int32; see pointops."""
    _check("xyz", xyz, torch.float32, 3, last=3)
    b, n, _ = xyz.shape
    if not _on_card(xyz):
        return pointops.farthest_point_sampling(xyz, num_samples)
    if num_samples >= n:  # every point, as the TPU wrapper does: no kernel
        return pointops.fps_identity(b, n, num_samples, xyz.device)
    out = torch.empty((b, num_samples), dtype=torch.int32, device=xyz.device)
    # above FPS_SHARED_POINTS the kernel keeps its running minima in scratch
    min_d = (torch.empty((b, n), dtype=torch.float32, device=xyz.device)
             if n > FPS_SHARED_POINTS else None)
    _launch("fps", "caspr_fps", xyz.device, xyz.data_ptr(), out.data_ptr(),
            None if min_d is None else min_d.data_ptr(), b, n, num_samples)
    return out


def ball_query_pair(xyz, new_xyz, radius1, k1, radius2, k2):
    """Both grouping scales of an SA level in one pass:
    (B, N, 3) sources, (B, M, 3) centroids -> ((B, M, k1), (B, M, k2))."""
    _check("xyz", xyz, torch.float32, 3, last=3)
    _check("new_xyz", new_xyz, torch.float32, 3, last=3)
    _same_batch(xyz, new_xyz)
    if not _on_card(xyz, new_xyz):
        return pointops.ball_query_pair(xyz, new_xyz, radius1, k1, radius2, k2)
    return _ball_query_launch(xyz, new_xyz, radius1, k1, radius2, k2)


def ball_query(xyz, new_xyz, radius: float, num_samples: int):
    """Single-radius form: (B, N, 3), (B, M, 3) -> (B, M, K) int32."""
    _check("xyz", xyz, torch.float32, 3, last=3)
    _check("new_xyz", new_xyz, torch.float32, 3, last=3)
    _same_batch(xyz, new_xyz)
    if not _on_card(xyz, new_xyz):
        return pointops.ball_query(xyz, new_xyz, radius, num_samples)
    return _ball_query_launch(xyz, new_xyz, radius, num_samples, 0.0, 0)[0]


def _ball_query_launch(xyz, new_xyz, radius1, k1, radius2, k2):
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    if k1 < 1 or k2 < 0:
        raise ValueError(f"ball sizes must be positive, got {k1}, {k2}")
    out1 = torch.empty((b, m, k1), dtype=torch.int32, device=xyz.device)
    out2 = torch.empty((b, m, k2), dtype=torch.int32, device=xyz.device) if k2 else None
    _launch("ball_query", "caspr_ball_query_pair", xyz.device,
            xyz.data_ptr(), new_xyz.data_ptr(), out1.data_ptr(),
            out2.data_ptr() if k2 else None, b, n, m,
            pointops.radius_sq(radius1), k1,
            pointops.radius_sq(radius2) if k2 else 0.0, k2)
    return out1, out2


def gather_points(points, idx):
    """points (B, N, C) float32, idx (B, ...) int32 -> (B, ..., C), indices
    clamped to [0, N).  Differentiable in ``points`` on either device: the
    backward is a scatter-add over the clamped indices in plain PyTorch
    (the JAX package's is XLA too: pallas_kernels.py::_gather_rows_bwd)."""
    _check("points", points, torch.float32, 3)
    if not isinstance(idx, torch.Tensor) or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise TypeError("idx: expected a contiguous int32 tensor")
    _same_batch(points, idx)
    return _GatherPoints.apply(points, idx)


def _gather_launch(points, idx):
    if not _on_card(points, idx):
        return pointops.gather_points(points, idx)
    b, n, c = points.shape
    r = math.prod(idx.shape[1:])
    out = torch.empty((b, r, c), dtype=points.dtype, device=points.device)
    if out.numel() == 0:  # nothing to gather: no launch
        return out.reshape(*idx.shape, c)
    if n == 0:
        raise ValueError("gather: no rows to gather from (N = 0)")
    if r * c > GATHER_MAX_FLOATS or n * c > GATHER_MAX_FLOATS:
        raise ValueError(f"gather: R * C = {r * c} and N * C = {n * c} must be at most "
                         f"{GATHER_MAX_FLOATS} (the kernel's offsets within a batch are 32-bit)")
    _launch("gather", "caspr_gather_rows", points.device,
            points.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, c, r)
    return out.reshape(*idx.shape, c)


def _scatter_rows(values, flat_idx, n):
    """sum of the rows of values (B, R, C) into (B, n, C) at flat_idx (B, R)."""
    b, _, c = values.shape
    out = values.new_zeros((b, n, c))
    return out.scatter_add_(1, flat_idx[:, :, None].expand(-1, -1, c), values)


class _GatherPoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, idx):
        ctx.save_for_backward(idx)
        ctx.num_points = points.shape[1]
        return _gather_launch(points, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        b, n = idx.shape[0], ctx.num_points
        flat = idx.reshape(b, -1).long().clamp(0, n - 1)
        return _scatter_rows(grad.reshape(b, flat.shape[1], -1), flat, n), None


def three_nn(query_xyz, source_xyz):
    """(B, Nq, 3), (B, Ns, 3) with Ns >= 3 -> (dist2 (B, Nq, 3) float32,
    idx (B, Nq, 3) int32)."""
    _check("query_xyz", query_xyz, torch.float32, 3, last=3)
    _check("source_xyz", source_xyz, torch.float32, 3, last=3)
    _same_batch(query_xyz, source_xyz)
    b, nq, _ = query_xyz.shape
    ns = source_xyz.shape[1]
    if ns < 3:
        raise ValueError(f"three_nn needs at least 3 source points, got {ns}")
    if not _on_card(query_xyz, source_xyz):
        return pointops.three_nn(query_xyz, source_xyz)
    dist = torch.empty((b, nq, 3), dtype=torch.float32, device=query_xyz.device)
    idx = torch.empty((b, nq, 3), dtype=torch.int32, device=query_xyz.device)
    _launch("three_nn", "caspr_three_nn", query_xyz.device,
            query_xyz.data_ptr(), source_xyz.data_ptr(), dist.data_ptr(), idx.data_ptr(),
            b, nq, ns)
    return dist, idx


def three_interpolate(features, idx, weights):
    """features (B, M, C) float32, idx (B, N, 3) int32, weights (B, N, 3)
    float32 -> (B, N, C).  Differentiable in features and weights on either
    device, by plain PyTorch (the JAX package's backward is XLA too:
    pallas_kernels.py::_interp3_bwd): d features is a scatter-add of
    w * grad, d weights is sum_c grad * F[idx]."""
    _check("features", features, torch.float32, 3)
    _check("idx", idx, torch.int32, 3, last=3)
    _check("weights", weights, torch.float32, 3, last=3)
    _same_batch(features, idx, weights)
    if idx.shape != weights.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and weights {tuple(weights.shape)} differ")
    return _ThreeInterpolate.apply(features, idx, weights)


def _three_interpolate_launch(features, idx, weights):
    if not _on_card(features, idx, weights):
        return pointops.three_interpolate(features, idx, weights)
    b, m, c = features.shape
    n = idx.shape[1]
    out = torch.empty((b, n, c), dtype=torch.float32, device=features.device)
    _launch("three_interpolate", "caspr_three_interpolate", features.device,
            features.data_ptr(), idx.data_ptr(), weights.data_ptr(), out.data_ptr(),
            b, m, n, c)
    return out


class _ThreeInterpolate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, idx, weights):
        ctx.save_for_backward(features, idx, weights)
        return _three_interpolate_launch(features, idx, weights)

    @staticmethod
    def backward(ctx, grad):
        features, idx, weights = ctx.saved_tensors
        b, m, c = features.shape
        flat = idx.reshape(b, -1).long().clamp(0, m - 1)  # (B, 3N)
        d_features = d_weights = None
        if ctx.needs_input_grad[0]:
            spread = (grad[:, :, None, :] * weights[..., None]).reshape(b, -1, c)
            d_features = _scatter_rows(spread, flat, m)
        if ctx.needs_input_grad[2]:
            d_weights = (grad[:, :, None, :] * pointops.gather_points(features, idx)).sum(-1)
        return d_features, None, d_weights


def _check_cnf(name, y, gb, w_first, w_hidden, w_last):
    """Shape agreement of the fused CNF kernels' arguments -> (bt, n, d, h,
    num_hidden)."""
    _check("y", y, torch.float32, 3)
    _check("gb", gb, torch.float32, 3)
    _check("w_first", w_first, torch.float32, 2)
    _check("w_hidden", w_hidden, torch.float32, 3)
    _check("w_last", w_last, torch.float32, 2)
    bt, n, d = y.shape
    h = w_first.shape[0]
    num_hidden = w_hidden.shape[0]
    if (gb.shape[0] != bt or gb.shape[2] != h or gb.shape[1] < 2 * (num_hidden + 2)
            or tuple(w_first.shape) != (h, d) or tuple(w_hidden.shape[1:]) != (h, h)
            or tuple(w_last.shape) != (d, h)):
        raise ValueError(
            f"{name} shapes disagree: y {tuple(y.shape)}, gb {tuple(gb.shape)}, "
            f"w_first {tuple(w_first.shape)}, w_hidden {tuple(w_hidden.shape)}, "
            f"w_last {tuple(w_last.shape)}")
    return bt, n, d, h, num_hidden


def _check_cnf_kernel_limits(name, h, d):
    """What the kernels take (``cnf_fused.kernel_takes`` sends every other
    config to the composition, so the model never reaches this raise)."""
    if h % KERNEL_WIDTH_STEP or h > KERNEL_MAX_WIDTH or d > KERNEL_MAX_DIM:
        raise ValueError(f"{name} kernel takes H a multiple of {KERNEL_WIDTH_STEP} up to "
                         f"{KERNEL_MAX_WIDTH} and D <= {KERNEL_MAX_DIM}, got H={h}, D={d}")


def _weights_scratch(w_hidden, matmul_dtype):
    """Scratch for the hidden weights as the tensor-core CNF kernels make
    them at each call (csrc/cnf_tc.cuh), per layer H_pad x H_pad values,
    H_pad = H rounded up to a multiple of 128: their TF32 hi and lo parts
    (2 floats a weight) for "f32", their bfloat16 rounding for "bf16"."""
    num_hidden, h, _ = w_hidden.shape
    h_pad = -(-h // 128) * 128
    if matmul_dtype == "bf16":
        return torch.empty(num_hidden * h_pad * h_pad, dtype=torch.bfloat16,
                           device=w_hidden.device)
    return torch.empty(2 * num_hidden * h_pad * h_pad, dtype=torch.float32, device=w_hidden.device)


def _cnf_route(kernel: str, matmul_dtype: str):
    """(launch count, C entry) of a CNF kernel in a matmul mode."""
    if matmul_dtype == "bf16":
        return f"{kernel}_bf16", f"caspr_{kernel}_bf16"
    return kernel, f"caspr_{kernel}"


def cnf_primal(y, gb, w_first, w_hidden, w_last, matmul_dtype: str = "f32"):
    """Fused concatsquash stack.  y (BT, N, D); gb (BT, G, H) gates and
    effective biases (ops/cnf_fused.py::context_gb); w_first (H, D),
    w_hidden (L-2, H, H), w_last (D, H) in (out, in) layout -> dx (BT, N, D).
    ``matmul_dtype``: "f32" (3xTF32 on the card) or "bf16" (every product's
    operands rounded to bfloat16, one tensor-core pass; the JAX package's
    CASPR_TPU_CNF_MATMUL=bf16)."""
    check_matmul_dtype(matmul_dtype)
    bt, n, d, h, num_hidden = _check_cnf("cnf_primal", y, gb, w_first, w_hidden, w_last)
    if not _on_card(y, gb, w_first, w_hidden, w_last):
        # the float32 call keeps the plain version's five-argument form,
        # which tests/test_torch_port_tf32x3.py swaps for its TF32 model
        if matmul_dtype == "bf16":
            return primal_packed(y, gb, w_first, w_hidden, w_last, matmul_dtype="bf16")
        return primal_packed(y, gb, w_first, w_hidden, w_last)
    _check_cnf_kernel_limits("cnf_primal", h, d)
    scratch = _weights_scratch(w_hidden, matmul_dtype)
    dx = torch.empty_like(y)
    _launch(*_cnf_route("cnf_primal", matmul_dtype), y.device,
            y.data_ptr(), gb.data_ptr(), w_first.data_ptr(), w_hidden.data_ptr(),
            w_last.data_ptr(), scratch.data_ptr(), dx.data_ptr(), bt, n, h, d, num_hidden,
            gb.shape[1])
    return dx


def cnf_dynamics(y, e, gb, w_first, w_hidden, w_last, matmul_dtype: str = "f32",
                 bwd_matmul_dtype: str = "f32"):
    """Fused concatsquash stack with the Hutchinson tangent.  y, e (BT, N, D);
    the other arguments as ``cnf_primal`` -> (dx (BT, N, D), div (BT, N) =
    e^T J e).  Differentiable in y, gb and the weights on either device: the
    backward is ``cnf_dynamics_vjp`` in ``bwd_matmul_dtype``, float32 by
    default in either forward mode, as the JAX package's default backward
    differentiates the float32 composition, and "bf16" (with a bf16
    forward) as its CASPR_TPU_CNF_BWD=pallas (e is a constant, as in the
    adjoint)."""
    check_matmul_dtype(matmul_dtype)
    check_matmul_dtype(bwd_matmul_dtype)
    _check_cnf("cnf_dynamics", y, gb, w_first, w_hidden, w_last)
    _check("e", e, torch.float32, 3)
    if e.shape != y.shape:
        raise ValueError(f"cnf_dynamics: e {tuple(e.shape)} and y {tuple(y.shape)} differ")
    return _CNFDynamics.apply(y, e, gb, w_first, w_hidden, w_last, matmul_dtype,
                              bwd_matmul_dtype)


def _cnf_dynamics_launch(y, e, gb, w_first, w_hidden, w_last, matmul_dtype):
    bt, n, d, h, num_hidden = _check_cnf("cnf_dynamics", y, gb, w_first, w_hidden, w_last)
    if not _on_card(y, e, gb, w_first, w_hidden, w_last):
        if matmul_dtype == "bf16":  # the float32 call as in cnf_primal
            return dynamics_packed(y, e, gb, w_first, w_hidden, w_last, matmul_dtype="bf16")
        return dynamics_packed(y, e, gb, w_first, w_hidden, w_last)
    _check_cnf_kernel_limits("cnf_dynamics", h, d)
    scratch = _weights_scratch(w_hidden, matmul_dtype)
    dx = torch.empty_like(y)
    div = torch.empty((bt, n), dtype=torch.float32, device=y.device)
    _launch(*_cnf_route("cnf_dynamics", matmul_dtype), y.device,
            y.data_ptr(), e.data_ptr(), gb.data_ptr(), w_first.data_ptr(),
            w_hidden.data_ptr(), w_last.data_ptr(), scratch.data_ptr(), dx.data_ptr(),
            div.data_ptr(), bt, n, h, d, num_hidden, gb.shape[1])
    return dx, div


class _CNFDynamics(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, e, gb, w_first, w_hidden, w_last, matmul_dtype, bwd_matmul_dtype):
        ctx.save_for_backward(y, e, gb, w_first, w_hidden, w_last)
        ctx.bwd_matmul_dtype = bwd_matmul_dtype
        return _cnf_dynamics_launch(y, e, gb, w_first, w_hidden, w_last, matmul_dtype)

    @staticmethod
    def backward(ctx, ct_dx, ct_div):
        y, e, gb, w_first, w_hidden, w_last = ctx.saved_tensors
        dy, dgb, dwf, dwh, dwl = cnf_dynamics_vjp(
            y, e, gb, w_first, w_hidden, w_last, ct_dx.contiguous(), ct_div.contiguous(),
            ctx.bwd_matmul_dtype)
        return dy, None, dgb, dwf, dwh, dwl, None, None


def cnf_dynamics_vjp(y, e, gb, w_first, w_hidden, w_last, ct_dx, ct_div,
                     matmul_dtype: str = "f32"):
    """The VJP of ``cnf_dynamics`` with respect to y, gb and the weights,
    for cotangents ct_dx (BT, N, D) and ct_div (BT, N) -> (dy (BT, N, D),
    dgb (BT, G, H) laid out as gb, dw_first (H, D), dw_hidden (L-2, H, H),
    dw_last (D, H)); dgb is summed over each cloud's points, the dW over
    every point.  ``matmul_dtype``: "f32" (3xTF32 on the card) or "bf16"
    (both operands of every product -- the forward recompute, the input
    cotangents, the weight gradients -- rounded to bfloat16, one tensor-core
    pass; the JAX package's _fused_bwd_call with matmul_dtype="bf16").
    Deterministic on the card: every sum has a fixed order."""
    check_matmul_dtype(matmul_dtype)
    bt, n, d, h, num_hidden = _check_cnf("cnf_dynamics_vjp", y, gb, w_first, w_hidden, w_last)
    for name, t in (("e", e), ("ct_dx", ct_dx)):
        _check(name, t, torch.float32, 3)
        if t.shape != y.shape:
            raise ValueError(f"cnf_dynamics_vjp: {name} {tuple(t.shape)} and y {tuple(y.shape)} differ")
    _check("ct_div", ct_div, torch.float32, 2)
    if tuple(ct_div.shape) != (bt, n):
        raise ValueError(f"cnf_dynamics_vjp: ct_div {tuple(ct_div.shape)}, expected {(bt, n)}")
    if not _on_card(y, e, gb, w_first, w_hidden, w_last, ct_dx, ct_div):
        return dynamics_vjp_packed(y, e, gb, w_first, w_hidden, w_last, ct_dx, ct_div,
                                   matmul_dtype)
    _check_cnf_kernel_limits("cnf_dynamics_vjp", h, d)
    lo, hi = KERNEL_HIDDEN_LAYERS
    if not lo <= num_hidden <= hi:
        raise ValueError(f"cnf_dynamics_vjp kernel takes {lo} to {hi} hidden layers, got {num_hidden}")
    lib = _library()
    w_hidden_t = w_hidden.transpose(1, 2).contiguous()
    dy = torch.empty_like(y)
    dgb = torch.empty_like(gb)
    dw = torch.empty(2 * h * d + num_hidden * h * h, dtype=torch.float32, device=y.device)
    workspace = vjp_workspace(lib, matmul_dtype, bt, n, h, d, num_hidden, y.device)
    _launch(*_cnf_route("cnf_dynamics_vjp", matmul_dtype), y.device,
            y.data_ptr(), e.data_ptr(), gb.data_ptr(), w_first.data_ptr(),
            w_hidden_t.data_ptr(), w_hidden.data_ptr(), w_last.data_ptr(), ct_dx.data_ptr(),
            ct_div.data_ptr(), dy.data_ptr(), dgb.data_ptr(), dw.data_ptr(),
            workspace.data_ptr(), bt, n, h, d, num_hidden, gb.shape[1])
    dw_first = dw[: h * d].view(h, d)
    dw_hidden = dw[h * d: h * d + num_hidden * h * h].view(num_hidden, h, h)
    dw_last = dw[h * d + num_hidden * h * h:].view(d, h)
    return dy, dgb, dw_first, dw_hidden, dw_last


def vjp_workspace(lib, matmul_dtype, bt, n, h, d, num_hidden, device):
    """The VJP kernel's workspace: floats for the float32 variant, bytes
    (its bfloat16 tiles beside float32 sums) for the bfloat16 one."""
    if matmul_dtype == "bf16":
        return torch.empty(lib.caspr_cnf_dynamics_vjp_bf16_workspace(bt, n, h, d, num_hidden),
                           dtype=torch.uint8, device=device)
    return torch.empty(lib.caspr_cnf_dynamics_vjp_workspace(bt, n, h, d, num_hidden),
                       dtype=torch.float32, device=device)


def _check_emd(xyz1, xyz2, dtype):
    _check("xyz1", xyz1, dtype, 3, last=3)
    _check("xyz2", xyz2, dtype, 3, last=3)
    _same_batch(xyz1, xyz2)
    pairs, n, _ = xyz1.shape
    m = xyz2.shape[1]
    if n < 1 or m < 1:
        raise ValueError(f"emd takes clouds of at least one point, got {n}, {m}")
    return pairs, n, m


def emd_cluster_size(pairs: int, n: int, dtype=torch.float32, device=None) -> int:
    """CTAs per cloud pair in the emd kernel's thread-block cluster (1 to 8)
    for a launch of ``pairs`` pairs with N = ``n``: the card's choice, from
    the clusters of each size it holds at once (csrc/emd.cu)."""
    with torch.cuda.device(device):
        size = _library().caspr_emd_cluster_size(pairs, n, int(dtype == torch.float64))
    if size < 1:
        raise RuntimeError(f"caspr_emd_cluster_size failed with cudaError_t {-size}")
    return size


def _emd_launch(kernel, entry, xyz1, xyz2, pairs, n, m):
    cost = torch.empty((pairs,), dtype=xyz1.dtype, device=xyz1.device)
    if pairs:
        scratch = torch.empty((pairs, 2 * (n + m)), dtype=xyz1.dtype, device=xyz1.device)
        _launch(kernel, entry, xyz1.device, xyz1.data_ptr(), xyz2.data_ptr(), cost.data_ptr(),
                scratch.data_ptr(), pairs, n, m,
                emd_cluster_size(pairs, n, xyz1.dtype, xyz1.device))
    return cost


def approx_match_emd(xyz1, xyz2):
    """Approxmatch EMD cost per cloud pair: xyz1 (P, N, 3), xyz2 (P, M, 3)
    float32 -> (P,).  No gradient flows through it on either device: the
    differentiable form is ``ops.metrics.approx_match_emd``."""
    pairs, n, m = _check_emd(xyz1, xyz2, torch.float32)
    if not _on_card(xyz1, xyz2):
        with torch.no_grad():
            return emd_plain(xyz1, xyz2)
    return _emd_launch("emd", "caspr_approx_match_emd", xyz1, xyz2, pairs, n, m)


def approx_match_emd_float64(xyz1, xyz2):
    """The emd kernel's body in float64, on CUDA tensors of that type -> (P,).
    For showing that the body is the algorithm (it agrees with the float64
    plain version to rounding); nothing of the port's paths calls it, and it
    is no launch of ``emd``."""
    pairs, n, m = _check_emd(xyz1, xyz2, torch.float64)
    if not _on_card(xyz1, xyz2) or not pairs:
        raise ValueError("approx_match_emd_float64 runs only on the card, on at least one pair")
    return _emd_launch(None, "caspr_approx_match_emd_f64", xyz1, xyz2, pairs, n, m)


def sa_fused(t, u, gidx, sp):
    """One SA scale after its factored conv1 (ops/sa_fused.py): t (B, N, d1)
    over the source points, u (B, M, d1) over the centres, gidx (B, M, K)
    int32, sp the mini-PointNet's parameters (three convs in (out, in)
    layout, the first folded into t and u; three GroupNorms) -> (B, M, d3):
    GroupNorm(16) + ReLU of t[idx] - u (indices clamped to [0, N)), conv2 +
    GroupNorm + ReLU, conv3 + GroupNorm, max over K.  No gradient flows
    through it on either device: ``ops.sa_fused.fused_sa_scale`` is the
    differentiable form.  Deterministic on the card (fixed sum orders).
    The kernel forms t[idx] - u, the first GroupNorm and every GroupNorm's
    statistics in float64 and runs conv2 and conv3 on the tensor cores in
    a 3xTF32 split (see csrc/sa_fused.cu), so on the card it is closer to
    the float64 value of the stack than its float32 plain version is.  It
    reads the parameters where they lie: the wrapper launches the kernel
    and nothing else, unless a parameter is not contiguous or not 16-byte
    aligned, which it copies."""
    _check("t", t, torch.float32, 3)
    _check("u", u, torch.float32, 3)
    _check("gidx", gidx, torch.int32, 3)
    _same_batch(t, u, gidx)
    b, n, d1 = t.shape
    m, k = gidx.shape[1:]
    convs, norms = sp["convs"], sp["norms"]
    if len(convs) != 3 or len(norms) != 3:
        raise ValueError(f"sa_fused: expected 3 convs and 3 norms, got {len(convs)}, {len(norms)}")
    _check_shape("u", u, (b, m, d1))
    d2, d3 = convs[1]["weight"].shape[0], convs[2]["weight"].shape[0]
    params = {"w2": (convs[1]["weight"], (d2, d1)), "b2": (convs[1]["bias"], (d2,)),
              "w3": (convs[2]["weight"], (d3, d2)), "b3": (convs[2]["bias"], (d3,))}
    for i, d in enumerate((d1, d2, d3)):
        params[f"gn{i}_weight"] = (norms[i]["weight"], (d,))
        params[f"gn{i}_bias"] = (norms[i]["bias"], (d,))
    for name, (tensor, shape) in params.items():
        if not isinstance(tensor, torch.Tensor) or tensor.dtype != torch.float32:
            raise TypeError(f"sa_fused: {name} must be a float32 tensor")
        _check_shape(name, tensor, shape)
    if not _on_card(t, u, gidx, *(tensor for tensor, _ in params.values())):
        with torch.no_grad():
            return sa_stack_plain(t, u, gidx, sp)
    if (n < 1 or not 1 <= k <= MAX_K
            or any(d % NUM_GROUPS or d > MAX_WIDTH for d in (d1, d2, d3))):
        raise ValueError(f"sa_fused kernel takes N >= 1, K <= {MAX_K} and widths that are multiples "
                         f"of {NUM_GROUPS} up to {MAX_WIDTH}, got N={n}, K={k}, {(d1, d2, d3)}")
    w2, b2, w3, b3, g1, be1, g2, be2, g3, be3 = (
        _aligned(tensor) for tensor, _ in params.values())
    t, u = _aligned(t), _aligned(u)
    out = torch.empty((b, m, d3), dtype=torch.float32, device=t.device)
    if out.numel():
        _launch("sa_fused", "caspr_sa_fused", t.device,
                t.data_ptr(), u.data_ptr(), gidx.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                w3.data_ptr(), b3.data_ptr(), g1.data_ptr(), be1.data_ptr(), g2.data_ptr(),
                be2.data_ptr(), g3.data_ptr(), be3.data_ptr(), out.data_ptr(),
                b, n, m, k, d1, d2, d3)
    return out


def _aligned(tensor):
    """tensor itself where it is contiguous and 16-byte aligned (the
    kernel's float4 and cp.async reads), else a copy that is."""
    if tensor.is_contiguous() and tensor.data_ptr() % 16 == 0:
        return tensor
    return tensor.clone(memory_format=torch.contiguous_format)


def sa_fused_instance(k: int, d1: int, d2: int, d3: int) -> int:
    """Which instantiation of the sa_fused kernel takes balls of K and the
    widths (d1, d2, d3): 1-9 for the encoder's nine shapes, 0 for the
    generic one (csrc/sa_fused.cu).  Needs the built library."""
    return _library().caspr_sa_fused_instance(k, d1, d2, d3)


def three_nn_split(b: int, nq: int) -> int:
    """The lanes the three_nn kernel splits each query's sources over for
    B x Nq queries (csrc/three_nn.cu).  Needs the built library."""
    return _library().caspr_three_nn_split(b, nq)
