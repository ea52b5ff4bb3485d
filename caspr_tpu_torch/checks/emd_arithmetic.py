"""How far the EMD kernel is from the float64 value of the algorithm, and why.

    python3 -m caspr_tpu_torch.checks.emd_arithmetic        (needs a CUDA card)

For several cloud sizes it computes the approxmatch cost of seeded uniform
clouds with the float64 plain version (ops/emd_plain.py) and prints, one
JSON line per size, the largest and the mean relative distance from it of

  - the kernel's body in float64: rounding only (1e-12 or so) if the body
    is the algorithm;
  - the float32 kernel that the port runs;
  - the float32 plain version;

and the kernel's milliseconds per launch (median of 5 CUDA-event timings).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..ops import kernels
from ..ops.emd_plain import emd_plain

SIZES = ((40, 2048, 2048), (64, 100, 150), (64, 128, 128), (16, 64, 1024))


def _ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("emd_arithmetic: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for pairs, n, m in SIZES:
        a = torch.rand((pairs, n, 3), generator=gen, device=dev)
        b = torch.rand((pairs, m, 3), generator=gen, device=dev)
        exact = emd_plain(a.double(), b.double())

        def rel(got):
            err = (got.double() - exact).abs() / exact
            return {"max": float(err.max()), "mean": float(err.mean())}

        row = {
            "pairs": pairs, "n": n, "m": m,
            "float64_body": rel(kernels.approx_match_emd_float64(a.double(), b.double())),
            "float32_kernel": rel(kernels.approx_match_emd(a, b)),
            "float32_plain_version": rel(emd_plain(a, b)),
        }
        row["float32_kernel"]["ms"] = _ms(lambda: kernels.approx_match_emd(a, b))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
