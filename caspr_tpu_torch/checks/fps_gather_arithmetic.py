"""The index arithmetic of the fps and gather kernels, modelled on the CPU.

``csrc/fps.cu`` picks each FPS step's point in three reductions over the
running minima (``fps_pick``): every thread takes the largest of the points
it owns (t, t + T, ...: by a tree of pairs up to 8192 points, by a scan
above, the lower index winning a tie), each warp takes the largest float
bits with ``__reduce_max_sync`` and the lowest index among the lanes that
hold them with ``__reduce_min_sync``, the winners go to a partials array,
and the partials are reduced the same way.  The running minima are >= 0 or
+inf, so their float bits order as uint32; the pick must be
``torch.argmax``'s, the first maximum.  ``fps_block_shape`` is the kernel's
choice of T and of points per thread.

``csrc/gather.cu`` splits a flat output offset q into (row, channel) by
q / C computed as (q * mul) >> shift (``fastdiv_params``), exact for every
q < 2^31, and writes each batch's output as 16-byte pieces from its first
16-byte boundary on, the floats before and after them one by one
(``gather_rows_model``).

Used by the CPU tests (tests/test_torch_port_fps_gather.py); nothing on the
port's paths calls them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.pointops import _sqnorm3

WARP = 32
FPS_PER_THREAD = 8  # csrc/fps.cu kPerThread
FPS_MAX_THREADS = 1024
NO_INDEX = 0xFFFFFFFF  # above every point's index


def fps_block_shape(n: int):
    """(threads, points per thread) of the fps kernel for a cloud of n points:
    up to 8192 points (fps_kernel) 8 points a thread and W warps, W the
    least power of two with 256 W >= n; above, 1024 threads
    (fps_global_kernel)."""
    if n <= FPS_PER_THREAD * FPS_MAX_THREADS:
        warps = 1
        while warps * WARP * FPS_PER_THREAD < n:
            warps *= 2
        return warps * WARP, FPS_PER_THREAD
    return FPS_MAX_THREADS, -(-n // FPS_MAX_THREADS)


def float_bits(values: torch.Tensor) -> torch.Tensor:
    """float32 -> their bits as uint32 values, held in int64."""
    return values.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def warp_pick(bits: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """(..., 32) bits and indices of a warp's lanes -> (...,) the lowest index
    among the lanes with the largest bits: __reduce_max_sync, then
    __reduce_min_sync over the indices of the lanes that hold the maximum."""
    top = bits.max(-1, keepdim=True).values
    return torch.where(bits == top, index, torch.full_like(index, NO_INDEX)).min(-1).values


def fps_pick(min_d: torch.Tensor) -> int:
    """The index the fps kernel picks from the running minima min_d (N,)
    float32 (all >= 0 or +inf)."""
    n = min_d.numel()
    threads, per = fps_block_shape(n)
    # thread t owns t + k * threads; a slot past the cloud holds 0 (fps_kernel)
    vals = torch.zeros(per * threads, dtype=torch.float32)
    vals[:n] = min_d
    vals = vals.view(per, threads)
    j = torch.arange(per * threads, dtype=torch.int64).view(per, threads)
    if n <= FPS_PER_THREAD * FPS_MAX_THREADS:  # fps_kernel: a tree of pairs
        v, at = list(vals), list(j)
        w = 1
        while w < per:
            for k in range(0, per - w, 2 * w):
                right = v[k + w] > v[k]  # strict: the lower index on a tie
                v[k] = torch.where(right, v[k + w], v[k])
                at[k] = torch.where(right, at[k + w], at[k])
            w *= 2
        best, best_j = v[0], at[0]
    else:  # fps_global_kernel: the scan in rising index order, strict >
        best = torch.full((threads,), -1.0)
        best_j = torch.zeros(threads, dtype=torch.int64)
        for k in range(per):
            take = vals[k] > best
            best = torch.where(take, vals[k], best)
            best_j = torch.where(take, j[k], best_j)
    bits = float_bits(best).view(-1, WARP)
    lanes = best_j.view(-1, WARP)
    won = warp_pick(bits, lanes)  # one per warp
    won_bits = bits[lanes == won[:, None]]  # the winning lane's bits, one per warp
    if won_bits.numel() != won.numel():
        raise AssertionError("a warp's pick is not held by exactly one lane")
    # the partials, one per warp, in lanes 0..W-1; the other lanes hold
    # (0, NO_INDEX)
    part_bits = torch.zeros(WARP, dtype=torch.int64)
    part_index = torch.full((WARP,), NO_INDEX, dtype=torch.int64)
    part_bits[:won.numel()] = won_bits
    part_index[:won.numel()] = won
    pick = int(warp_pick(part_bits, part_index))
    if int((part_index == pick).sum()) != 1:
        raise AssertionError("the pick is not held by exactly one partial")
    return pick


def fps_model(xyz: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Greedy FPS (B, N, 3) -> (B, M) int32 with each step's pick by
    fps_pick and the distances of pointops.farthest_point_sampling."""
    b, n, _ = xyz.shape
    out = torch.zeros((b, num_samples), dtype=torch.int32)
    for c in range(b):
        min_d = torch.full((n,), float("inf"))
        last = 0
        for s in range(1, num_samples):
            min_d = torch.minimum(min_d, _sqnorm3(xyz[c] - xyz[c, last]))
            last = fps_pick(min_d)
            out[c, s] = last
    return out


def fastdiv_params(d: int):
    """(mul, shift) with q // d == (q * mul) >> shift for 0 <= q < 2^31
    (csrc/gather.cu make_fastdiv): shift = 31 + l with 2^l >= d, mul =
    ceil(2^shift / d), below 2^32."""
    if not 1 <= d < 2**31:
        raise ValueError(f"divisor {d} outside [1, 2^31)")
    l = (d - 1).bit_length()
    shift = 31 + l
    mul = ((1 << shift) + d - 1) // d
    return mul, shift


def fastdiv(q, mul: int, shift: int):
    """(q * mul) >> shift, as the kernel's 32 x 32 -> 64-bit product; q an
    int or an int64 array of values in [0, 2^31)."""
    if isinstance(q, int):
        return (q * mul) >> shift
    return (np.asarray(q, dtype=np.uint64) * np.uint64(mul)) >> np.uint64(shift)


def gather_pieces(length: int, misaligned: int):
    """The flat offsets one batch's threads write: (pieces (P, 4), singles)
    for an output run of ``length`` floats whose first float sits
    ``misaligned`` floats past a 16-byte boundary."""
    head = min((4 - misaligned) % 4, length)
    count = (length - head) // 4
    pieces = head + 4 * np.arange(count, dtype=np.int64)[:, None] + np.arange(4)
    singles = np.concatenate([np.arange(head), np.arange(head + 4 * count, length)])
    return pieces, singles.astype(np.int64)


def gather_rows_model(src: np.ndarray, idx: np.ndarray, misaligned: int = 0):
    """out[b, r, :] = src[b, clamp(idx[b, r]), :] as the gather kernel
    computes it: src (B, N, C) float32, idx (B, R) int32, the output's first
    float ``misaligned`` floats past a 16-byte boundary.
    Returns (out (B, R, C), times each output float was written)."""
    b, n, c = src.shape
    r = idx.shape[1]
    length = r * c
    mul, shift = fastdiv_params(c)
    out = np.zeros(b * length, dtype=src.dtype)
    writes = np.zeros(b * length, dtype=np.int64)
    for bb in range(b):
        pieces, singles = gather_pieces(length, (misaligned + bb * length) % 4)
        q = np.concatenate([pieces.ravel(), singles])
        row = fastdiv(q, mul, shift).astype(np.int64)
        i = np.clip(idx[bb, row], 0, n - 1)
        out[bb * length + q] = src[bb, i, q - row * c]
        np.add.at(writes, bb * length + q, 1)
    return out.reshape(b, r, c), writes.reshape(b, r, c)
