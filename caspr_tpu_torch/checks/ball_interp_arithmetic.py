"""The index arithmetic of the ball-query and interpolation kernels,
modelled on the CPU.

``csrc/ball_query.cu`` gives each centroid a warp that tests 32 sources a
step (``scan_group``): lane l takes source base + l of the chunk of the
cloud staged in shared memory, and a warp tests each step against a group
of 1, 2 or 4 of its centroids.  Per centroid, one 32-bit ballot mask on the
larger radius says whether the step has a hit; only then is the smaller
radius's mask taken (a centroid whose lists are both full takes no more
hits), and for each list a hit's slot is the list's count
plus the popcount of the mask below its lane (written when below K), the
count grows by the mask's popcount, and the first hit is the mask's lowest
set bit at the first non-zero mask.  The cloud streams through chunks of
``chunk`` sources (a multiple of 32; the kernel's is ``kernel_chunk``),
the slots past the cloud hold +inf, the counts and first hits carry from
one chunk to the next, and a group whose lists are all full stops.  The
padding is the first hit (0 if none).  ``ball_block_shape`` is the host's
choice of the centroids each warp takes and of the group size.

``csrc/three_interpolate.cu`` gives each query row a warp
(``interpolate_model``): block x of batch y owns rows 8x .. 8x + 7, warp w
row 8x + w, and its lanes walk the channels as float4 pieces (lane l takes
pieces l, l + 32, ...) when C % 4 == 0 and the features and the output sit
at 16-byte boundaries, or one float at a time otherwise; each output float
is (w0*F[i0] + w1*F[i1]) + w2*F[i2], every product and sum rounded to
float32 on its own, with the indices clamped to [0, M).

Used by the CPU tests (tests/test_torch_port_ball_interp.py); nothing on
the port's paths calls them.
"""

from __future__ import annotations

import numpy as np

WARP = 32
WARPS = 8  # warps a block of either kernel has
MAX_PER_WARP = 8  # csrc/ball_query.cu kMaxPerWarp
KERNEL_CHUNK = 4096  # csrc/ball_query.cu kMaxChunk
RESIDENT_WARPS = 132 * 48  # csrc/ball_query.cu kResidentWarps
_BITS = 1 << np.arange(WARP, dtype=np.int64)


def sqnorm3(d: np.ndarray) -> np.ndarray:
    """(..., 3) float32 -> (dx*dx + dy*dy) + dz*dz, each product and sum
    rounded to float32 on its own (numpy fuses no multiply-add)."""
    d = d.astype(np.float32)
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def kernel_chunk(n: int) -> int:
    """Sources the kernel stages at a time: N rounded up to the warp, at
    most KERNEL_CHUNK."""
    return min(-(-n // WARP) * WARP, KERNEL_CHUNK)


def ball_block_shape(b: int, m: int, resident_warps: int = RESIDENT_WARPS):
    """(centroids a warp takes, centroids it tests at once, centroids a
    block takes, blocks along the centroids): about one centroid per
    resident warp, 1 to 8 a warp, in groups of 4, 2 or 1."""
    want = min(max(-(-(b * m) // resident_warps), 1), MAX_PER_WARP)
    group = 4 if want >= 4 else (2 if want >= 2 else 1)
    per_warp = -(-want // group) * group
    tile = WARPS * per_warp
    return per_warp, group, tile, -(-m // tile)


def block_centroids(block: int, warp: int, per_warp: int):
    """The centroid slots warp ``warp`` of block ``block`` takes, in order
    (slots at or past M count as full lists and write nothing)."""
    first = block * WARPS * per_warp + warp
    return [first + WARPS * i for i in range(per_warp)]


def _mask(inside: np.ndarray) -> int:
    """__ballot_sync: bit l set where lane l is true."""
    return int((_BITS * inside).sum())


def _popc(x: int) -> int:
    return bin(x).count("1")


def scan_group(src: np.ndarray, centers: np.ndarray, real, r2a: float, k1: int, r2b: float,
               k2: int, chunk: int):
    """One warp's group: src (N, 3) float32, centers (G, 3) float32, real
    (G,) whether each slot is a centroid (else its lists count as full),
    the float32 thresholds r2a, r2b and list sizes k1, k2 (k2 = 0: one
    radius).  Returns ([(G, k1), (G, k2)] lists, the steps of 32 sources the
    group ran)."""
    n = src.shape[0]
    if chunk % WARP or chunk < WARP:
        raise ValueError(f"chunk {chunk} is no positive multiple of {WARP}")
    g_count = centers.shape[0]
    ks = (k1, k2)
    first_out = k2 == 0 or r2a >= r2b  # list 1 is the larger ball's
    r_out, r_in = (np.float32(r2a), np.float32(r2b)) if first_out else (np.float32(r2b),
                                                                          np.float32(r2a))
    lists = [np.zeros((g_count, k), np.int32) for k in ks]
    count = [[k if not real[g] else 0 for k in ks] for g in range(g_count)]
    first = [[0, 0] for _ in range(g_count)]

    def full(g):
        return count[g][0] >= k1 and count[g][1] >= k2

    steps = 0
    for start in range(0, n, chunk):  # the chunk in shared memory, +inf past the cloud
        if all(full(g) for g in range(g_count)):
            continue
        length = min(chunk, n - start)
        staged = np.full((-(-length // WARP) * WARP, 3), np.inf, np.float32)
        staged[:length] = src[start:start + length]
        for base in range(0, staged.shape[0], WARP):
            d = sqnorm3(centers[:, None, :] - staged[None, base:base + WARP])  # (G, 32)
            steps += 1
            mo = [0 if full(g) else _mask(d[g] < r_out) for g in range(g_count)]
            if not any(mo):
                continue
            at = start + base
            for g in range(g_count):
                if not mo[g]:
                    continue
                io, ii = d[g] < r_out, d[g] < r_in
                mi = _mask(ii)
                for r, (m, inside) in enumerate(((mo[g], io), (mi, ii)) if first_out
                                                else ((mi, ii), (mo[g], io))):
                    if not m or count[g][r] >= ks[r]:
                        continue
                    if count[g][r] == 0:
                        first[g][r] = at + (m & -m).bit_length() - 1  # __ffs - 1
                    for lane in np.flatnonzero(inside):
                        slot = count[g][r] + _popc(m & ((1 << int(lane)) - 1))
                        if slot < ks[r]:
                            lists[r][g, slot] = at + int(lane)
                    count[g][r] += _popc(m)
            if all(full(g) for g in range(g_count)):
                break
    for g in range(g_count):  # the padding, in parallel in the kernel
        for r, k in enumerate(ks):
            lists[r][g, min(count[g][r], k):] = first[g][r]
    return lists, steps


def ball_query_model(xyz: np.ndarray, centers: np.ndarray, r2a: float, k1: int, r2b: float,
                     k2: int, chunk: int = KERNEL_CHUNK, resident_warps: int = RESIDENT_WARPS):
    """The kernel's lists for every centroid: xyz (B, N, 3), centers (B, M,
    3) float32 -> ((B, M, k1), (B, M, k2) int32, steps (B, M): the steps of
    the group that scanned each centroid), each centroid scanned by the warp
    and group ``ball_block_shape`` assigns it to (each exactly once).  The
    kernel runs the groups of a warp chunk by chunk, one group after the
    other in each chunk; a group's lists depend on nothing else, so the
    model runs each group through all chunks in turn."""
    b, _, _ = xyz.shape
    m = centers.shape[1]
    out1 = np.full((b, m, k1), -1, np.int32)
    out2 = np.full((b, m, k2), -1, np.int32)
    steps = np.zeros((b, m), np.int64)
    seen = np.zeros((b, m), np.int64)
    per_warp, group, _, blocks = ball_block_shape(b, m, resident_warps)
    for bb in range(b):
        for block in range(blocks):
            for warp in range(WARPS):
                slots = block_centroids(block, warp, per_warp)
                for i0 in range(0, per_warp, group):
                    members = slots[i0:i0 + group]
                    real = [c < m for c in members]
                    if not any(real):
                        continue
                    cen = centers[bb, [min(c, m - 1) for c in members]]
                    (l1, l2), n_steps = scan_group(xyz[bb], cen, real, r2a, k1, r2b, k2, chunk)
                    for g, c in enumerate(members):
                        if real[g]:
                            out1[bb, c], out2[bb, c], steps[bb, c] = l1[g], l2[g], n_steps
                            seen[bb, c] += 1
    if not (seen == 1).all():
        raise AssertionError("a centroid is scanned other than once")
    return out1, out2, steps


def interp_vectorised(c: int, feature_offset: int = 0, out_offset: int = 0) -> bool:
    """The float4 walk: C % 4 == 0 and both bases at 16-byte boundaries
    (offsets in floats from one)."""
    return c % 4 == 0 and feature_offset % 4 == 0 and out_offset % 4 == 0


def interpolate_model(features: np.ndarray, idx: np.ndarray, weights: np.ndarray,
                      feature_offset: int = 0, out_offset: int = 0):
    """out (B, N, C) as the kernel writes it: features (B, M, C) float32, idx
    (B, N, 3) int32, weights (B, N, 3) float32; the bases ``*_offset``
    floats past a 16-byte boundary pick the walk.  Returns (out, times each
    output float was written)."""
    b, m, c = features.shape
    n = idx.shape[1]
    vec = interp_vectorised(c, feature_offset, out_offset)
    width = 4 if vec else 1
    items = c // width  # float4 pieces or floats of a row
    out = np.zeros((b, n, c), np.float32)
    writes = np.zeros((b, n, c), np.int64)
    lanes = np.arange(WARP)
    for bb in range(b):  # blockIdx.y
        for block in range(-(-n // WARPS)):  # blockIdx.x
            for warp in range(WARPS):
                q = block * WARPS + warp
                if q >= n:
                    continue
                i = np.clip(idx[bb, q], 0, m - 1)
                w = weights[bb, q].astype(np.float32)
                rows = features[bb, i]  # (3, C)
                for v0 in range(0, items, WARP):
                    v = v0 + lanes
                    v = v[v < items]
                    ch = (width * v[:, None] + np.arange(width)).ravel()
                    out[bb, q, ch] = (rows[0, ch] * w[0] + rows[1, ch] * w[1]) + rows[2, ch] * w[2]
                    writes[bb, q, ch] += 1
    return out, writes
