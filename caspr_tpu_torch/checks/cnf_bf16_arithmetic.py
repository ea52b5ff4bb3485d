"""The arithmetic of the bfloat16 forward CNF kernels, modelled on the CPU.

    python3 -m caspr_tpu_torch.checks.cnf_bf16_arithmetic        (needs a CUDA card and nvcc)

The bfloat16 variants of ``csrc/cnf_primal.cu`` and ``csrc/cnf_dynamics.cu``
run on the bfloat16 layer tile of ``csrc/cnf_tc.cuh``: each layer's
epilogue rounds its outputs to bfloat16 once and stores them, the next
product reads them as they are, and softplus (with the tangent's sigmoid)
runs on the special-function units.  This module models the three parts:

  - ``primal_tile`` / ``dynamics_tile``: the stacks with every activation
    rounded to bfloat16 where the epilogue stores it, and each product of
    the stored values with the rounded weights in float32.  The bf16 plain
    versions (``ops/cnf_fused.py``: ``primal_packed`` / ``dynamics_packed``
    with ``matmul_dtype="bf16"``) round the same float32 values at every
    product instead, so the two give the same bits.  The activations are
    parameters: exact, perturbed (``perturbed``), or the kernels' own
    algorithm (``softplus_sfu``);
  - ``softplus_sfu`` / ``softplus_sigmoid_sfu``: cnf_tc.cuh's algorithm
    step by step in float32 -- u = 2^(-|x| log2 e), log1p(u) from its series
    below 1/16 and from lg2(1 + u) ln 2 above, the sigmoid from rcp(1 + u)
    -- with ex2, lg2 and rcp exact then rounded to float32, or off by the
    relative (ex2, rcp) or absolute (lg2) errors given: the special-function
    units' error bounds (PTX ISA: ex2.approx.ftz.f32 2 ulp, lg2.approx.ftz.f32
    2^-22 absolute, rcp.approx.ftz.f32 1 ulp) bound the hardware's;
  - ``btile_at``, ``weight_slot``, ``a_operand_at`` and ``b_operand_at``:
    the byte offsets of the tile and of the tiled weights as cnf_tc.cuh
    computes them, and where the wgmma descriptors read each operand
    element from (K-major core matrices of 8 rows x 16 B, LBO apart in K,
    SBO apart in M or N), so that the layout can be checked element by
    element without a compiler.

The bfloat16 VJP (``csrc/cnf_dynamics_vjp.cu``'s ``vjp_bf16_kernel`` and
``wgrad_bf16_kernel``) runs on the same tile, and this module models it too:

  - ``vjp_tile``: the VJP with each layer input z_l and each dm_l rounded to
    bfloat16 once, where the tile kernel stores them (in the tile and, as
    the tile's bytes, in the workspace), the pre-gate products m_l float32,
    the forward's softplus and sigmoid from ``act`` and the reverse sweep's
    sigmoid from ``sigmoid`` (exact, or ``sigmoid_sfu``: the sigmoid of
    ``softplus_sigmoid_sfu``);
  - ``workspace_at``, ``mn_operand_at``, ``gemm_stage_source`` and
    ``m_slot``: where the tile kernel writes each element of z and dm in the
    workspace, where the weight-gradient product's bulk copies and MN-major
    descriptors read dm^T and z from, and the pre-gate products' fragment
    order, each as the kernels compute them.

Used by ``tests/test_torch_port_bf16_tile.py``,
``tests/test_torch_port_bf16_vjp_tile.py`` and ``chip_smoke.py``; nothing on
the port's paths calls them.

Run as a module on the card, it builds a probe of cnf_tc.cuh's
``softplus_sfu`` and ``softplus_sigmoid_sfu`` (``sfu_probe``) and prints
their largest relative error against float64 over float32 inputs from -87.3
to 88 (where softplus is a normal float32), and below.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from ..ops.cnf_fused import softplus

SFU_BAR = 2.0 ** -16          # relative error of softplus_sfu and the sigmoid
NORMAL_FROM = -87.3           # softplus(x) is a normal float32 from here up
EX2_ERR, LG2_ERR, RCP_ERR = 2.0 ** -22, 2.0 ** -22, 2.0 ** -23
_LOG2E = np.float32(1.44269502)
_LN2 = np.float32(0.693147182)
_TINY = 2.0 ** -126

# the tile (cnf_tc.cuh)
ROWS, CHUNK_N, SLICE_K = 64, 64, 16
TILE_LBO = ROWS // 8 * 128 + 16
SLICE_BYTES = CHUNK_N * SLICE_K * 2   # kSliceT: a tiled K-slice of a warpgroup's chunk
SUB = 8                                  # kSubT: K-slices a ring stage


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 holding the nearest bfloat16 (ties to even), as
    cvt.rn.bf16x2.f32 and __float2bfloat16_rn."""
    return x.to(torch.bfloat16).to(x.dtype)


def exact_softplus_sigmoid(x):
    """softplus and sigmoid as the bf16 plain versions form them."""
    return softplus(x), torch.sigmoid(x)


def perturbed(rel: float, seed: int | None = None):
    """softplus and sigmoid, each multiplied by 1 + rel (1 - rel where rel
    < 0), or by 1 +- |rel| with a random sign per value when ``seed`` is
    given: an activation ``rel`` off, as the bar on the kernels' allows."""
    def act(x):
        sp, sig = exact_softplus_sigmoid(x)
        if seed is None:
            f = torch.full_like(x, rel, dtype=torch.float64)
        else:
            g = torch.Generator().manual_seed(seed)
            f = abs(rel) * (2.0 * torch.randint(0, 2, x.shape, generator=g) - 1.0).double()
        return (sp.double() * (1 + f)).float(), (sig.double() * (1 + f)).float()
    return act


def _f32(t):
    return t.to(torch.float32)


def _fma(a, b, c):
    """float32 fmaf: the product exact in float64, the sum rounded once
    (twice, float64 then float32, which can differ from one rounding only
    on ties of the float64 sum)."""
    return _f32(a.double() * b.double() + c.double())


def softplus_sigmoid_sfu(x: torch.Tensor, ex2_err: float = 0.0, lg2_err: float = 0.0,
                         rcp_err: float = 0.0):
    """(softplus, sigmoid) of float32 x as cnf_tc.cuh's softplus_sigmoid_sfu
    computes them (softplus_sfu is its first half): float32 steps, the
    special functions exact to float64 then off by ex2_err, rcp_err
    (relative) and lg2_err (absolute), flushed to zero below 2^-126 (ftz)."""
    if x.dtype != torch.float32:
        raise TypeError(f"softplus_sigmoid_sfu takes float32, got {x.dtype}")
    t = x.abs() * torch.tensor(-_LOG2E)                      # float32 multiply
    u = _f32(torch.exp2(t.double()) * (1 + ex2_err))
    u = torch.where(u < _TINY, torch.zeros_like(u), u)
    w = 1.0 + u                                               # float32 add
    r = _f32(1.0 / w.double() * (1 + rcp_err))
    sig = torch.where(x >= 0, r, u * r)
    one = torch.ones_like(u)
    series = u * _fma(u, _fma(u, _fma(u, _fma(u, 0.2 * one, -0.25 * one),
                                      torch.tensor(np.float32(0.333333343)) * one),
                              -0.5 * one), one)
    lg = _f32(torch.log2(w.double()) + lg2_err) * torch.tensor(_LN2)
    log1p = torch.where(u < 0.0625, series, lg)
    return torch.clamp_min(x, 0.0) + log1p, sig


def sfu_rel_errors(x: torch.Tensor, sp: torch.Tensor, sig: torch.Tensor) -> dict:
    """Largest relative error of (sp, sig) against float64 softplus and
    sigmoid of the float32 inputs x, over x >= NORMAL_FROM, and the largest
    absolute error below it."""
    x64 = x.double()
    sp64 = torch.logaddexp(x64, torch.zeros_like(x64))
    sig64 = torch.sigmoid(x64)
    normal = x >= NORMAL_FROM
    rel = lambda a, b: float(((a.double() - b).abs() / b.abs())[normal].max())
    out = {"softplus_rel": rel(sp, sp64), "sigmoid_rel": rel(sig, sig64)}
    if (~normal).any():
        out["softplus_abs_below"] = float((sp.double() - sp64).abs()[~normal].max())
    return out


def sfu_inputs(n: int = 1 << 20) -> torch.Tensor:
    """float32 inputs a layer's pre-activations span: a uniform grid over
    [-100, 100], a dense one over [-4, 4] (both sides of u = 1/16 at |x| =
    ln 16), every float32 within 64 units of |x| = ln 16 and of 0."""
    parts = [torch.linspace(-100.0, 100.0, n, dtype=torch.float64),
             torch.linspace(-4.0, 4.0, n, dtype=torch.float64)]
    base = torch.tensor([np.log(16.0), -np.log(16.0), 1e-30, -1e-30],
                        dtype=torch.float32).view(torch.int32)
    steps = torch.arange(-64, 65, dtype=torch.int32)
    near = (base[:, None] + steps[None, :]).reshape(-1).view(torch.float32)
    return torch.cat([_f32(p) for p in parts] + [near])


def primal_tile(y, gb, w_first, w_hidden, w_last, act=exact_softplus_sigmoid):
    """The bf16 primal kernel's function: y rounded once, each activation
    rounded once where it is stored, float32 products of stored values and
    rounded weights; ``act`` gives (softplus, sigmoid)."""
    weights = [w_first, *w_hidden.unbind(0), w_last]
    num_layers = len(weights)
    z = round_bf16(y)
    for i, w in enumerate(weights):
        d_out = w.shape[0]
        gate = gb[:, i, None, :d_out]
        beff = gb[:, num_layers + i, None, :d_out]
        z = torch.matmul(z, round_bf16(w).T) * gate + beff
        if i < num_layers - 1:
            z = round_bf16(act(z)[0])
    return z


def dynamics_tile(y, e, gb, w_first, w_hidden, w_last, act=exact_softplus_sigmoid):
    """The bf16 dynamics kernel's function: both streams as primal_tile's,
    the tangent rows zt * sigmoid stored rounded too; the divergence with e
    as given."""
    weights = [w_first, *w_hidden.unbind(0), w_last]
    num_layers = len(weights)
    zp, zt = round_bf16(y), round_bf16(e)
    for i, w in enumerate(weights):
        d_out = w.shape[0]
        gate = gb[:, i, None, :d_out]
        beff = gb[:, num_layers + i, None, :d_out]
        wt = round_bf16(w).T
        zp = torch.matmul(zp, wt) * gate + beff
        zt = torch.matmul(zt, wt) * gate
        if i < num_layers - 1:
            sp, sig = act(zp)
            zt, zp = round_bf16(zt * sig), round_bf16(sp)
    return zp, (zt * e).sum(dim=-1)


def sigmoid_sfu(x: torch.Tensor, ex2_err: float = 0.0, rcp_err: float = 0.0):
    """cnf_tc.cuh's sigmoid_sfu: softplus_sigmoid_sfu's sigmoid."""
    return softplus_sigmoid_sfu(x, ex2_err=ex2_err, rcp_err=rcp_err)[1]


def vjp_tile(y, e, gb, w_first, w_hidden, w_last, ct_dx, ct_div, act=exact_softplus_sigmoid,
             sigmoid=torch.sigmoid):
    """The bf16 VJP kernels' function (csrc/cnf_dynamics_vjp.cu, bfloat16
    variant), in the stream-stacked form of ``dynamics_vjp_packed``: each
    layer input z_l rounded once where the forward recompute stores it, m_l
    = z_l W_l^T (float32 sums of rounded operands) kept as it is, each dm_l
    rounded once where the reverse sweep stores it, and every product (dm
    W_l, dm^T z_l) of the stored values and the rounded weights; ``act``
    gives the forward's (softplus, sigmoid), ``sigmoid`` the reverse
    sweep's.  Returns (dy, dgb, dw_first, dw_hidden, dw_last)."""
    weights = [w_first, *w_hidden.unbind(0), w_last]
    num_layers = len(weights)
    n = y.shape[1]
    z = round_bf16(torch.cat([y, e], dim=1))
    zs, ms = [], []
    for i, w in enumerate(weights):
        zs.append(z)
        m = torch.matmul(z, round_bf16(w).T)
        ms.append(m)
        if i < num_layers - 1:
            d_out = w.shape[0]
            pre_p = m[:, :n] * gb[:, i, None, :d_out] + gb[:, num_layers + i, None, :d_out]
            pre_t = m[:, n:] * gb[:, i, None, :d_out]
            sp, sig = act(pre_p)
            z = round_bf16(torch.cat([sp, pre_t * sig], dim=1))
    cp, ct = ct_dx, ct_div[..., None] * e
    dgb = torch.zeros_like(gb)
    dws = [None] * num_layers
    for i in range(num_layers - 1, -1, -1):
        w, m = weights[i], ms[i]
        d_out = w.shape[0]
        gate = gb[:, i, None, :d_out]
        if i == num_layers - 1:
            dppre, dtpre = cp, ct
        else:
            pre_p = m[:, :n] * gate + gb[:, num_layers + i, None, :d_out]
            pre_t = m[:, n:] * gate
            s = sigmoid(pre_p)
            dppre = cp * s + ct * pre_t * s * (1.0 - s)
            dtpre = ct * s
        dgb[:, num_layers + i, :d_out] = dppre.sum(dim=1)
        dgb[:, i, :d_out] = (dppre * m[:, :n] + dtpre * m[:, n:]).sum(dim=1)
        dm = round_bf16(torch.cat([dppre, dtpre], dim=1) * gate)
        dws[i] = torch.matmul(dm.reshape(-1, d_out).T, zs[i].reshape(-1, w.shape[1]))
        dz = torch.matmul(dm, round_bf16(w))
        cp, ct = dz[:, :n], dz[:, n:]
    return cp, dgb, dws[0], torch.stack(dws[1:-1]), dws[-1]


# ------------------------------------------------------------ the layout

def btile_at(r, c):
    """Byte offset of row r, column c in a bfloat16 tile (cnf_tc.cuh)."""
    return (c >> 3) * TILE_LBO + (r >> 3) * 128 + (r & 7) * 16 + (c & 7) * 2


def padded_width(h: int) -> int:
    return (h + 127) // 128 * 128


def weight_slot(l, o, k, hpad):
    """Element index of W_l[o, k] in tile_weights_kernel's output."""
    ks, nch, half = hpad // SLICE_K, hpad // (2 * CHUNK_N), hpad // 2
    wg, c, oc = o // half, (o % half) // CHUNK_N, o % CHUNK_N
    kl = k % SLICE_K
    return ((((l * 2 + wg) * nch + c) * ks + k // SLICE_K) * (SLICE_BYTES // 2)
            + (oc // 8) * 128 + (kl // 8) * 64 + (oc % 8) * 8 + kl % 8)


def rotated_slice(k, ks, block):
    """cnf_tc.cuh's rotated_slice for the block of linear index ``block``."""
    rot = block % ks
    return k + rot if k + rot < ks else k + rot - ks


def stage_pieces(s, ks, block, wg):
    """The bulk copies load_tslice issues for stage s of warpgroup wg's
    stream (step s % spc of chunk (s // spc) % nch of layer s // (spc nch),
    spc = ks / SUB, nch = ks / 8): (byte offset in the tiled weights, bytes,
    byte offset in the stage); two where the SUB K-slices wrap past the
    chunk's last."""
    spc, nch = ks // SUB, ks // 8
    lc = s // spc
    kk = rotated_slice((s % spc) * SUB, ks, block)
    head = min(SUB, ks - kk)
    src = (((lc // nch) * 2 + wg) * nch + lc % nch) * ks * SLICE_BYTES
    pieces = [(src + kk * SLICE_BYTES, head * SLICE_BYTES, 0)]
    if head < SUB:
        pieces.append((src, (SUB - head) * SLICE_BYTES, head * SLICE_BYTES))
    return pieces


def stage_source(s, ks, block, wg, offset):
    """The byte of the tiled weights that lands at ``offset`` of stage s of
    warpgroup wg's ring."""
    for src, size, dst in stage_pieces(s, ks, block, wg):
        if dst <= offset < dst + size:
            return src + offset - dst
    raise ValueError(offset)


def _kmajor(row, k, lbo, sbo):
    """Byte offset of element (row, k) of a K-major operand without swizzle:
    8-row x 16-byte core matrices, LBO apart along K, SBO apart along the
    rows (the wgmma descriptor's canonical layout)."""
    return (row // 8) * sbo + (k // 8) * lbo + (row % 8) * 16 + (k % 8) * 2


def a_operand_at(m, k, kk):
    """Byte offset in the tile of element (m, k) (m < 64, k < 16) of the A
    operand of K-slice kk: a_desc(tile + kk * 2 * TILE_LBO), LBO TILE_LBO,
    SBO 128."""
    return kk * 2 * TILE_LBO + _kmajor(m, k, TILE_LBO, 128)


def b_operand_at(n, k, j):
    """Byte offset in a stage of element (n, k) (n < 64, k < 16) of the B
    operand of the stage's K-slice j: b_desc(stage + j * SLICE_BYTES), LBO
    128, SBO 256."""
    return j * SLICE_BYTES + _kmajor(n, k, 128, 256)


def btile_bytes(hpad: int) -> int:
    """Bytes of a bfloat16 tile, its K-chunk pads included."""
    return hpad // 8 * TILE_LBO


def workspace_at(block, r, c, hpad):
    """Byte offset in the VJP workspace's z or dm array of a layer, of row r
    (0..63) and channel c of tile block ``block``: the tile kernel copies its
    tile there whole, one tile after the other."""
    return block * btile_bytes(hpad) + btile_at(r, c)


def mn_operand_at(mn, k, lbo=128, sbo=TILE_LBO):
    """Byte offset of element (mn, k) of an MN-major operand without
    swizzle: core matrices of 8 K-rows x 16 B (8 elements along M or N), LBO
    apart along K, SBO apart along M or N (the canonical layout an
    MN-major wgmma descriptor reads; the kernel's mn_desc)."""
    return (mn // 8) * sbo + (k // 8) * lbo + (k % 8) * 16 + (mn % 8) * 2


GEMM_TILE = 128                           # dW rows and columns of a block
GEMM_OPERAND = GEMM_TILE // 8 * TILE_LBO  # bytes of one operand of a stage


def gemm_stage_source(block, channel0, offset, hpad):
    """The workspace byte that the weight-gradient product's bulk copy of
    tile block ``block`` puts at ``offset`` of a stage's operand whose
    channels start at ``channel0`` (o0 for dm, k0 for z)."""
    if not 0 <= offset < GEMM_OPERAND:
        raise ValueError(offset)
    return block * btile_bytes(hpad) + (channel0 // 8) * TILE_LBO + offset


def gemm_a_at(wg, half, kstep, m, k):
    """Offset in a stage's A operand (dm) of element (m, k) of warpgroup
    wg's product for K-step kstep of half ``half``: mn_desc(A + wg 8 LBO +
    512 half + 256 kstep)."""
    return wg * 8 * TILE_LBO + 512 * half + 256 * kstep + mn_operand_at(m, k)


def gemm_b_at(half, kstep, n, k):
    """Offset in a stage's B operand (z) of element (n, k) of the product
    for K-step kstep of half ``half``: mn_desc(B + 512 half + 256 kstep)."""
    return 512 * half + 256 * kstep + mn_operand_at(n, k)


def m_slot(r, c):
    """(float4 index, component) of m[row r, channel c] in a tile block's
    slice of the pre-gate products: the slot of the thread whose
    accumulator fragment holds it (warp w = r / 16 of its warpgroup, lane 4
    (r % 8) + (c % 8) / 2), channel group c / 8 outermost; components a0, a1
    (row r0, channels c, c + 1) and a2, a3 (row r0 + 8)."""
    w, g, half = (r % 64) // 16, r % 8, (r % 16) // 8
    lane = 4 * g + (c % 8) // 2
    return ((c // 8) * 4 + w) * 32 + lane, 2 * half + c % 2


def m_slot_first_layer(p, c):
    """Where the first layer stores m of point p's primal row and channel
    pair c (even): cnf_tc.cuh's first_layer_streams_bf16, (c / 8) 128 + (p /
    8) 32 + (p % 8) 4 + (c % 8) / 2."""
    return (c >> 3) * 128 + (p >> 3) * 32 + (p & 7) * 4 + ((c & 7) >> 1)


def thin_wide_at(r, o, hpad):
    """Where the first and last layers' weight-gradient kernel reads row r,
    channel o of a tile array: warp r % 8's row group (r % 64) / 8 of tile
    block r / 64."""
    return ((r // 64) * btile_bytes(hpad) + (o >> 3) * TILE_LBO + (r % 8) * 16
            + ((r % 64) // 8) * 128 + (o & 7) * 2)


# ------------------------------------------------------- the card's probe

_PROBE = r"""
#include "%(header)s"
using namespace caspr::cnf_tc;
__global__ void probe(const float* x, float* sp, float* sp2, float* sig, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  sp[i] = softplus_sfu(x[i]);
  softplus_sigmoid_sfu(x[i], sp2[i], sig[i]);
}
extern "C" int caspr_sfu_probe(const float* x, float* sp, float* sp2, float* sig, int n) {
  probe<<<(n + 255) / 256, 256>>>(x, sp, sp2, sig, n);
  return static_cast<int>(cudaGetLastError());
}
"""


def sfu_probe(x: torch.Tensor) -> dict:
    """Build a probe of cnf_tc.cuh's softplus_sfu and softplus_sigmoid_sfu
    (nvcc, into _build/sfu_probe/), run it on x (float32, on the card) and
    return sfu_rel_errors of both (the softplus of the two must agree)."""
    import ctypes

    from ..ops import kernels

    out_dir = kernels.BUILD_DIR / "sfu_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "probe.cu", out_dir / "probe.so"
    src.write_text(_PROBE % {"header": kernels.CSRC / "cnf_tc.cuh"})
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)],
                   check=True, capture_output=True, timeout=600)
    fn = ctypes.CDLL(str(lib)).caspr_sfu_probe
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    fn.restype = ctypes.c_int
    sp, sp2, sig = (torch.empty_like(x) for _ in range(3))
    err = fn(x.data_ptr(), sp.data_ptr(), sp2.data_ptr(), sig.data_ptr(), x.numel())
    torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"sfu probe: launch failed with cudaError_t {err}")
    if not torch.equal(sp, sp2):
        raise AssertionError("softplus_sfu and softplus_sigmoid_sfu's softplus differ")
    return sfu_rel_errors(x.cpu(), sp.cpu(), sig.cpu())


def main() -> int:
    if not torch.cuda.is_available():
        print("cnf_bf16_arithmetic: no CUDA device", file=sys.stderr)
        return 2
    x = sfu_inputs(1 << 22)
    card = sfu_probe(x.cuda())
    model = sfu_rel_errors(x, *softplus_sigmoid_sfu(x))
    print(json.dumps({"sfu_probe": card, "cpu_model": model, "bar": SFU_BAR,
                      "inputs": int(x.numel()), "device": torch.cuda.get_device_name(0)}),
          flush=True)
    return 0 if max(card["softplus_rel"], card["sigmoid_rel"]) <= SFU_BAR else 1


if __name__ == "__main__":
    sys.exit(main())
