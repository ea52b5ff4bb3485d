"""The arithmetic of the tensor-core CNF kernels, modelled on the CPU.

    python3 -m caspr_tpu_torch.checks.tf32x3_arithmetic        (needs a CUDA card)

``csrc/cnf_primal.cu`` and ``csrc/cnf_dynamics.cu`` run each hidden layer
(H x H) on the tensor cores in a 3xTF32 split (``csrc/cnf_tc.cuh``): with
a = a_hi + a_lo and b = b_hi + b_lo, each part rounded to TF32, a layer sums
a_hi b_hi + a_hi b_lo + a_lo b_hi over its inputs in float32; the first and
last layers stay in float32 on CUDA cores.  ``primal_tf32x3`` and
``dynamics_tf32x3`` model that: the three products in float64 from the
rounded parts, each hidden layer's sum cast to float32, everything else as
the float32 plain versions (``ops/cnf_fused.py``).  They differ from the
kernels only in the kernels' float32 sums (each K-slice of 8 on the tensor
cores, which add with truncation, then the slices in float32 with rounding
to nearest).  Used by the CPU tests and by ``chip_smoke.py``; nothing on
the port's paths calls them.

Run as a module on the card, it prints one JSON line per kernel at
``chip_smoke.py``'s phase-2 shapes (the trained decoder, 40 clouds of 2048
points): the relative distance (largest error over the largest magnitude)
of the kernel, of the emulation and of the float32 plain version from the
float64 plain version, for each output.
"""

from __future__ import annotations

import json
import sys

import torch

from ..ops.cnf_fused import softplus


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 with a 10-bit mantissa, rounded to nearest with
    ties away from zero (``cvt.rna.tf32.f32``), by integer operations on the
    bits: add half a unit of the last kept place to the magnitude, then clear
    the 13 dropped bits."""
    if x.dtype != torch.float32:
        raise TypeError(f"round_tf32 takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo), both TF32 values: hi = round_tf32(x), lo = round_tf32(x - hi)."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def matmul_tf32x3(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """z (..., K) @ w (N, K)^T as the kernels' hidden layers compute it:
    z_hi w_hi + z_hi w_lo + z_lo w_hi from the TF32 parts, summed in float64,
    cast to float32."""
    z_hi, z_lo = (p.double() for p in split_tf32(z))
    w_hi, w_lo = (p.double() for p in split_tf32(w))
    return (z_hi @ w_hi.T + z_hi @ w_lo.T + z_lo @ w_hi.T).float()


def primal_tf32x3(y, gb, w_first, w_hidden, w_last):
    """``ops.cnf_fused.primal_packed`` with the hidden layers in the 3xTF32
    split.  Float32 arguments; y (BT, N, D) -> dx (BT, N, D)."""
    weights = [w_first, *w_hidden.unbind(0), w_last]
    num_layers = len(weights)
    z = y
    for i, w in enumerate(weights):
        d_out = w.shape[0]
        gate = gb[:, i, None, :d_out]
        beff = gb[:, num_layers + i, None, :d_out]
        m = matmul_tf32x3(z, w) if 0 < i < num_layers - 1 else torch.matmul(z, w.T)
        z = m * gate + beff
        if i < num_layers - 1:
            z = softplus(z)
    return z


def dynamics_tf32x3(y, e, gb, w_first, w_hidden, w_last):
    """``ops.cnf_fused.dynamics_packed`` with the hidden layers in the
    3xTF32 split: (dx (BT, N, D), div (BT, N))."""
    weights = [w_first, *w_hidden.unbind(0), w_last]
    num_layers = len(weights)
    zp, zt = y, e
    for i, w in enumerate(weights):
        d_out = w.shape[0]
        gate = gb[:, i, None, :d_out]
        beff = gb[:, num_layers + i, None, :d_out]
        mm = (lambda z: matmul_tf32x3(z, w)) if 0 < i < num_layers - 1 else (
            lambda z: torch.matmul(z, w.T))
        zp = mm(zp) * gate + beff
        zt = mm(zt) * gate
        if i < num_layers - 1:
            zt = zt * torch.sigmoid(zp)
            zp = softplus(zp)
    return zp, (zt * e).sum(dim=-1)


def rel_distance(got: torch.Tensor, exact: torch.Tensor) -> float:
    """Largest error over the largest magnitude of the float64 value."""
    return float((got.double() - exact).abs().max() / exact.abs().max())


def phase2_inputs(device, bt=40, n=2048, seed=0):
    """The trained decoder (artifacts/demo_trained.pkl) at one evaluation:
    (y, e, gb, w_first, w_hidden, w_last) on ``device``, from ``seed``."""
    from ..ops import cnf_fused
    from ..weights import load_demo

    params, _ = load_demo(device=device)
    odenet = params["point_cnf"][1]["odenet"]
    gen = torch.Generator(device=device).manual_seed(seed)
    tc = torch.cat([torch.full((bt, 1), 0.25, device=device),
                    torch.randn((bt, 1600), generator=gen, device=device)], dim=1)
    y = torch.randn((bt, n, 3), generator=gen, device=device)
    e = torch.randn((bt, n, 3), generator=gen, device=device)
    return (y, e, cnf_fused.context_gb(odenet, tc), *cnf_fused.pack_weights(odenet))


def main() -> int:
    if not torch.cuda.is_available():
        print("tf32x3_arithmetic: no CUDA device", file=sys.stderr)
        return 2
    from ..ops import cnf_fused, kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    y, e, gb, wf, wh, wl = phase2_inputs(torch.device("cuda"))
    w64 = [t.double() for t in (gb, wf, wh, wl)]
    versions = {
        "cnf_primal": (
            lambda: (kernels.cnf_primal(y, gb, wf, wh, wl),),
            lambda: (primal_tf32x3(y, gb, wf, wh, wl),),
            lambda: (cnf_fused.primal_packed(y, gb, wf, wh, wl),),
            (cnf_fused.primal_packed(y.double(), *w64),), ("dx",)),
        "cnf_dynamics": (
            lambda: kernels.cnf_dynamics(y, e, gb, wf, wh, wl),
            lambda: dynamics_tf32x3(y, e, gb, wf, wh, wl),
            lambda: cnf_fused.dynamics_packed(y, e, gb, wf, wh, wl),
            cnf_fused.dynamics_packed(y.double(), e.double(), *w64), ("dx", "div")),
    }
    for name, (kernel, emulation, plain, exact, outputs) in versions.items():
        row = {"kernel": name, "shape": f"({y.shape[0]}, {y.shape[1]}, 3), H {wf.shape[0]}"}
        for label, fn in (("kernel", kernel), ("tf32x3_emulation", emulation),
                          ("float32_plain_version", plain)):
            row[label] = {out: rel_distance(got, x) for out, got, x in zip(outputs, fn(), exact)}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
