"""The arithmetic of the three_nn and sa_fused kernels, modelled on the CPU.

``csrc/three_nn.cu`` splits each query's sources over S lanes
(``three_nn_split``): lane s scans the sources j = s, s + S, ... of the
cloud, staged chunk by chunk and padded to a multiple of S with NaN
coordinates, in increasing index order, keeping its best three (distance
bits, index) with a strictly smaller distance; the S lists are then merged
by a shuffle butterfly (lane ^ 1, ^ 2, ...), two sorted triples at a time
in (distance, index) order.  ``three_nn_model`` runs exactly that, with
distances compared as their uint32 bits as the kernel does.

``csrc/sa_fused.cu`` takes tiles of TB whole balls of the flattened B x M
centres (``sa_config``: rows, balls, warps, ring pieces and shared memory of
each instantiation), forms h1 = t[idx] - u and GN1 in double (a team of
threads per (ball, group), elements strided over the team, then a
butterfly), runs conv2 and conv3 in the 3xTF32 split (each K-slice of 8
summed on its own, the slices added in float32), takes GN2's and GN3's
statistics in double from the conv outputs (each thread's rows, column
pairs where a group's width is even, a butterfly over the 8 row lanes, then
the group's columns in order), normalises in float32 with the mean split
as hi + lo (GN1: u + mean split, so that t - (u + mean) needs no double)
and writes GN3's affine of each channel's max or min over the ball.
``sa_fused_model`` runs that arithmetic in PyTorch on the CPU, tile by
tile: every sum in the kernel's order, the products of each K-slice summed
in float64 and rounded to float32 (the kernel's tensor cores sum a slice
with their own truncation, the one place where model and kernel differ).

Used by the CPU tests (tests/test_torch_port_three_nn_sa.py); nothing on
the port's paths calls them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.sa_fused import MAX_K, MAX_WIDTH, NUM_GROUPS
from .tf32x3_arithmetic import split_tf32

# ------------------------------------------------------------------ three_nn

THREADS = 256
Q = 2  # queries a lane owns (csrc/three_nn.cu kQ)
CHUNK = 2048  # sources staged at a time (kChunk)
WAVE_THREADS = 132 * 2048  # one full wave of the H100 (kWaveThreads)
NO_KEY = np.uint32(0xFFFFFFFF)  # an empty list slot
PAD = np.uint32(0x7FFFFFFF).view(np.float32)  # the padding's coordinates (NaN)


def three_nn_split(b: int, nq: int) -> int:
    """Lanes per query: the smallest power of two that gives the grid a
    full wave of threads (Q queries a lane), at most 32."""
    queries = b * nq
    s = 1
    while s < 32 and -(-queries // Q) * s < WAVE_THREADS:
        s *= 2
    return s


def sqnorm3(d: np.ndarray) -> np.ndarray:
    """(..., 3) float32 -> (dx*dx + dy*dy) + dz*dz, each product and sum
    rounded on its own (numpy fuses no multiply-add)."""
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def _insert(keys, idx, key, j):
    """The kernel's strict insertion of (key, j) into each sorted triple
    (keys, idx: lists of three arrays), elementwise."""
    k0, k1, k2 = keys
    i0, i1, i2 = idx
    lt0, lt1, lt2 = key < k0, key < k1, key < k2
    new_k2 = np.where(lt1, k1, np.where(lt2, key, k2))
    new_i2 = np.where(lt1, i1, np.where(lt2, j, i2))
    new_k1 = np.where(lt0, k0, np.where(lt1, key, k1))
    new_i1 = np.where(lt0, i0, np.where(lt1, j, i1))
    new_k0 = np.where(lt0, key, k0)
    new_i0 = np.where(lt0, j, i0)
    return [new_k0, new_k1, new_k2], [new_i0, new_i1, new_i2]


def _merge(ak, ai, bk, bi):
    """The first three of two sorted triples in (key, index) order, as the
    kernel's merge takes them: three times the smaller head, then a shift
    of the list it came from."""
    ak, ai, bk, bi = list(ak), list(ai), list(bk), list(bi)
    ok, oi = [], []
    for _ in range(3):
        take_b = (bk[0] < ak[0]) | ((bk[0] == ak[0]) & (bi[0] < ai[0]))
        ok.append(np.where(take_b, bk[0], ak[0]))
        oi.append(np.where(take_b, bi[0], ai[0]))
        for s in range(2):
            ak[s], ai[s] = np.where(take_b, ak[s], ak[s + 1]), np.where(take_b, ai[s], ai[s + 1])
            bk[s], bi[s] = np.where(take_b, bk[s + 1], bk[s]), np.where(take_b, bi[s + 1], bi[s])
    return ok, oi


def three_nn_model(query: np.ndarray, source: np.ndarray, s: int | None = None,
                   chunk: int = CHUNK):
    """query (B, Nq, 3), source (B, Ns, 3) float32, Ns >= 3 -> (dist2 (B,
    Nq, 3) float32, idx (B, Nq, 3) int32) as the kernel computes them with
    S = ``s`` lanes a query (default: ``three_nn_split``) and chunks of
    ``chunk`` staged sources (a multiple of S)."""
    query = np.asarray(query, np.float32)
    source = np.asarray(source, np.float32)
    b, nq, _ = query.shape
    ns = source.shape[1]
    s = three_nn_split(b, nq) if s is None else s
    if chunk % s:
        raise ValueError(f"chunk {chunk} is no multiple of S = {s}")
    shape = (s, b, nq)
    keys = [np.full(shape, NO_KEY, np.uint32) for _ in range(3)]
    idx = [np.zeros(shape, np.int64) for _ in range(3)]
    lanes = np.arange(s)
    for start in range(0, ns, chunk):
        length = min(chunk, ns - start)
        padded = -(-length // s) * s
        staged = np.full((b, padded, 3), PAD, np.float32)
        staged[:, :length] = source[:, start:start + length]
        for p in range(0, padded, s):
            pts = staged[:, p + lanes]  # (B, S, 3): lane l takes p + l
            d = sqnorm3(query[None, :, :, :] - pts.transpose(1, 0, 2)[:, :, None, :])
            j = (start + p + lanes)[:, None, None]
            keys, idx = _insert(keys, idx, d.view(np.uint32), j)
    m = 1
    while m < s:
        partner = lanes ^ m
        keys, idx = _merge(keys, idx, [k[partner] for k in keys], [i[partner] for i in idx])
        m *= 2
    dist = np.stack(keys, -1)[0].view(np.float32)
    return dist, np.stack(idx, -1)[0].astype(np.int32)


# ------------------------------------------------------------------- sa_fused

WARPS = 8
STAGES = 3
SMEM_LIMIT = 232448
EPS = 1e-5
# the encoder's (K; d1, d2, d3), in the order of caspr_sa_fused_instance
SHAPES = ((16, 16, 16, 32), (32, 32, 32, 64), (16, 32, 32, 64), (16, 64, 64, 128),
          (32, 64, 96, 128), (16, 128, 256, 256), (32, 128, 256, 256), (16, 256, 256, 512),
          (32, 256, 256, 512))


@dataclass(frozen=True)
class SAConfig:
    """One instantiation of the sa_fused kernel (csrc/sa_fused.cu Cfg)."""
    instance: int  # 1-9: SHAPES[instance - 1]; 0: the generic one
    kp: int  # rows a ball takes in a tile
    rows: int  # rows a tile holds (R)
    balls: int  # balls a tile holds (TB)
    nf2: int  # 8-column fragments a warp owns in conv2's pass
    nf3: int  # and in each of conv3's
    nc: int  # columns of a ring piece (a layer's pass)
    kc: int  # input channels of a ring piece
    smem_bytes: int

    @property
    def team(self) -> int:
        """Threads that sum one (ball, group) of GN1."""
        return THREADS // (self.balls * NUM_GROUPS)


def sa_config(k: int, d1: int, d2: int, d3: int) -> SAConfig:
    """The instantiation that takes balls of K and the widths (d1, d2,
    d3), with its tile and its shared memory for these widths."""
    if not 1 <= k <= MAX_K or any(d % NUM_GROUPS or not 0 < d <= MAX_WIDTH for d in (d1, d2, d3)):
        raise ValueError(f"no instantiation takes K={k}, {(d1, d2, d3)}")
    shape = (k, d1, d2, d3)
    instance = SHAPES.index(shape) + 1 if shape in SHAPES else 0
    if instance:
        kp = k
        rows = 128 if max(d2, d3) <= 64 else 64
        cw = WARPS // (rows // 32)
        nf2, nf3 = (min(8, d // (8 * cw)) for d in (d2, d3))
        nc = cw * 8 * max(nf2, nf3)
        kc = 16 if max(nf2, nf3) <= 4 else 32
    else:
        kp, rows, nf2, nf3, nc, kc = MAX_K, 32, 8, 8, 8 * 64, 16
    balls = rows // kp
    ld = max(d1, d2) + 4
    floats = (STAGES * nc * (kc + 4) + 4 * balls * nc + 4 * balls * NUM_GROUPS + 4 * balls * d1
              + rows * ld + rows)
    return SAConfig(instance, kp, rows, balls, nf2, nf3, nc, kc, 4 * floats)


def _lane_tree(v: torch.Tensor, dim: int, width: int) -> torch.Tensor:
    """The butterfly sum over ``width`` lanes along ``dim`` (each step adds
    the partner lane's value: lane ^ 1, ^ 2, ...); every lane ends with the
    same value, which is returned (lane 0's)."""
    lanes = torch.arange(width)
    bit = 1
    while bit < width:
        v = v + v.index_select(dim, lanes ^ bit)
        bit *= 2
    return v.select(dim, 0)


def _moments(s1: torch.Tensor, s2: torch.Tensor, n: int):
    mean = s1 / n
    var = torch.clamp_min(s2 / n - mean * mean, 0.0)
    return mean, 1.0 / torch.sqrt(var + EPS)


def norm_consts(mean: torch.Tensor, rstd: torch.Tensor):
    """A GroupNorm's (mean, rstd) in float64 -> (hi, lo, rstd) in float32:
    mean = hi + lo to float64's precision."""
    hi = mean.float()
    return hi, (mean - hi.double()).float(), rstd.float()


def _affine(x: torch.Tensor, hi, lo, rstd, gamma, beta) -> torch.Tensor:
    """GroupNorm's normalisation ((x - hi) - lo) * rstd and the affine, all
    in float32, each product and sum rounded on its own."""
    z = ((x - hi) - lo) * rstd
    return z * gamma + beta


def conv_tf32x3(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """a (R, din) @ w (dout, din)^T + bias as the kernel's conv computes it:
    both operands split by ``split_tf32``, per K-slice of 8 input channels
    the three TF32 products (a_lo b_hi +
    a_hi b_lo + a_hi b_hi) summed in float64 and rounded to float32, the
    slices added in float32 in order, then the bias."""
    a_hi, a_lo = (p.double() for p in split_tf32(a.contiguous()))
    w_hi, w_lo = (p.double() for p in split_tf32(w.contiguous()))
    acc = torch.zeros((a.shape[0], w.shape[0]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], 8):
        sl = slice(k0, k0 + 8)
        part = (a_lo[:, sl] @ w_hi[:, sl].T + a_hi[:, sl] @ w_lo[:, sl].T
                + a_hi[:, sl] @ w_hi[:, sl].T)
        acc = acc + part.float()
    return acc + bias


def group_stats_from_rows(v: torch.Tensor, k: int):
    """GN2's and GN3's statistics as the kernel's epilogue sums them: v
    (balls, KP, d) float32, rows past k left out -> (s1, s2) (balls, 16)
    float64.  Per column, each lane g of the 8 row lanes sums its rows
    g, 8 + g (then 16 + g, 24 + g) in that order; where a group's width is
    even the lane adds its two columns (2t, 2t + 1); a butterfly over the 8
    lanes; then the group's columns (or column pairs) in order."""
    balls, kp, d = v.shape
    cg = d // NUM_GROUPS
    x = v.double().masked_fill(torch.arange(kp)[None, :, None] >= k, 0.0)
    x = x.reshape(balls, kp // 8, 8, d)  # (ball, row block, lane g, column)
    s1 = x[:, 0].clone()
    s2 = x[:, 0] * x[:, 0]
    for blk in range(1, kp // 8):
        s1 = s1 + x[:, blk]
        s2 = s2 + x[:, blk] * x[:, blk]
    if cg % 2 == 0:  # column pairs (2t, 2t + 1): one group
        s1 = s1[..., 0::2] + s1[..., 1::2]
        s2 = s2[..., 0::2] + s2[..., 1::2]
    s1, s2 = _lane_tree(s1, 1, 8), _lane_tree(s2, 1, 8)  # (balls, slots)
    per = s1.shape[-1] // NUM_GROUPS
    g1 = s1[..., 0::per].clone()
    g2 = s2[..., 0::per].clone()
    for q in range(1, per):
        g1 = g1 + s1[..., q::per]
        g2 = g2 + s2[..., q::per]
    return g1, g2


def first_norm_stats(x: torch.Tensor, k: int, team: int):
    """GN1's statistics as the kernel sums them: x (balls, KP, d1) float64
    (t[idx] - u), rows past k left out -> (s1, s2) (balls, 16).  Team lane
    ``sub`` sums the group's elements e = sub, sub + team, ... (e = row *
    cg + channel), then a butterfly over the team."""
    balls, _, d1 = x.shape
    cg = d1 // NUM_GROUPS
    elems = x[:, :k].reshape(balls, k, NUM_GROUPS, cg).permute(0, 2, 1, 3).reshape(
        balls, NUM_GROUPS, k * cg)
    n = k * cg
    s1 = torch.zeros((balls, NUM_GROUPS, team), dtype=torch.float64)
    s2 = torch.zeros_like(s1)
    for e0 in range(0, n, team):
        chunk = elems[..., e0:e0 + team]
        live = chunk.shape[-1]
        s1[..., :live] = s1[..., :live] + chunk
        s2[..., :live] = s2[..., :live] + chunk * chunk
    return _lane_tree(s1, 2, team), _lane_tree(s2, 2, team)


def sa_tile_model(t, u, gidx, sp, cfg: SAConfig, centres: torch.Tensor):
    """One tile: the balls ``centres`` (indices into the flattened B x M,
    at most cfg.balls; the rest of the tile is empty) -> their (balls, d3)
    outputs."""
    b, n, d1 = t.shape
    m, k = gidx.shape[1:]
    tb, kp = cfg.balls, cfg.kp
    live = centres.numel()
    convs, norms = sp["convs"], sp["norms"]
    # the gather: rows past K and balls past the end are zeros
    rows = torch.zeros((tb, kp, d1), dtype=torch.float32)
    us = torch.zeros((tb, d1), dtype=torch.float32)
    flat_idx = gidx.reshape(b * m, k)[centres].long().clamp(0, n - 1)
    clouds = centres // m
    rows[:live, :k] = t[clouds[:, None], flat_idx]
    us[:live] = u.reshape(b * m, d1)[centres]
    x = rows.double() - us.double()[:, None, :]
    s1, s2 = first_norm_stats(x, k, cfg.team)
    cg = d1 // NUM_GROUPS
    mean, rstd = (v.repeat_interleave(cg, -1)[:, None, :] for v in _moments(s1, s2, k * cg))
    # (t - u) - mean = t - (u + mean), with u + mean split as hi + lo
    w_hi, w_lo, _ = norm_consts(us.double()[:, None, :] + mean, rstd)
    h = torch.relu(_affine(rows, w_hi, w_lo, rstd.float(), norms[0]["weight"], norms[0]["bias"]))
    h[:, k:] = 0.0
    for layer in (1, 2):
        w, bias = convs[layer]["weight"], convs[layer]["bias"]
        d = w.shape[0]
        v = conv_tf32x3(h.reshape(tb * kp, -1), w, bias).reshape(tb, kp, d)
        s1, s2 = group_stats_from_rows(v, k)
        cg = d // NUM_GROUPS
        consts = norm_consts(*(s.repeat_interleave(cg, -1)[:, None, :]
                               for s in _moments(s1, s2, k * cg)))
        gamma, beta = norms[layer]["weight"], norms[layer]["bias"]
        if layer == 1:
            h = torch.relu(_affine(v, *consts, gamma, beta))
            h[:, k:] = 0.0
        else:  # GN3's affine of each channel's max (or min, where gamma < 0)
            top = v[:, :k].amax(dim=1, keepdim=True)
            bottom = v[:, :k].amin(dim=1, keepdim=True)
            out = _affine(torch.where(gamma >= 0, top, bottom), *consts, gamma, beta)[:, 0]
    return out[:live]


def sa_fused_model(t, u, gidx, sp):
    """The kernel's output for t (B, N, d1), u (B, M, d1), gidx (B, M, K)
    and a mini-PointNet's parameters, all float32 / int32 on the CPU, tile
    by tile over the flattened B x M centres -> (B, M, d3)."""
    b, _, d1 = t.shape
    m, k = gidx.shape[1:]
    d2, d3 = (sp["convs"][i]["weight"].shape[0] for i in (1, 2))
    cfg = sa_config(k, d1, d2, d3)
    with torch.no_grad():
        outs = [sa_tile_model(t, u, gidx, sp, cfg, torch.arange(c0, min(c0 + cfg.balls, b * m)))
                for c0 in range(0, b * m, cfg.balls)]
    return torch.cat(outs).reshape(b, m, d3)
