"""Whether two runs of one CPU function give the same bits on this machine.

    python3 -m caspr_tpu_torch.checks.cpu_repeatability

Runs the plain CNF stack (ops/cnf_fused.py::primal_packed) and its parts --
the matrix products of its three layer shapes, and exp / log1p on a tensor
of the activations' size -- fifty times each on the same CPU tensors, and
prints how many different results came out (the buffers move between the
calls): first with the thread count PyTorch chose, then with one thread.  More than one result with several
threads and one with a single thread means that the library splits the
work between threads differently from call to call.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import torch

from ..ops import cnf_fused

REPEATS = 50


def _distinct(fn) -> int:
    """Different results among REPEATS calls; odd-sized buffers kept alive
    between the calls move the addresses of what each call allocates."""
    seen, kept = set(), []
    for i in range(REPEATS):
        kept.append(torch.empty(1000 + 37 * i))
        seen.add(hashlib.sha256(fn().contiguous().numpy().tobytes()).hexdigest())
    return len(seen)


def main() -> int:
    g = torch.Generator().manual_seed(0)
    bt, n, h = 4, 100, 64
    y = torch.randn((bt, n, 3), generator=g)
    gb = torch.rand((bt, 8, h), generator=g)
    wf = torch.randn((h, 3), generator=g)
    wh = torch.randn((2, h, h), generator=g) / h ** 0.5
    wl = torch.randn((3, h), generator=g) / h ** 0.5
    z = torch.randn((bt, n, h), generator=g)
    cases = {
        "primal_packed": lambda: cnf_fused.primal_packed(y, gb, wf, wh, wl),
        "matmul (4,100,3) x (3,64)": lambda: torch.matmul(y, wf.T),
        "matmul (4,100,64) x (64,64)": lambda: torch.matmul(z, wh[0].T),
        "matmul (4,100,64) x (64,3)": lambda: torch.matmul(z, wl.T),
        "exp": lambda: torch.exp(-z.abs()),
        "log1p": lambda: torch.log1p(z.abs()),
        "softplus": lambda: cnf_fused.softplus(z),
    }
    print(json.dumps({"torch": torch.__version__, "cpus": os.cpu_count(),
                      "env": {k: v for k, v in os.environ.items()
                              if k.startswith(("OMP_", "MKL_"))}}), flush=True)
    print(torch.__config__.parallel_info(), flush=True)
    for threads in (torch.get_num_threads(), 1):
        torch.set_num_threads(threads)
        print(json.dumps({"threads": threads,
                          "distinct_results_of_50": {k: _distinct(f) for k, f in cases.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
