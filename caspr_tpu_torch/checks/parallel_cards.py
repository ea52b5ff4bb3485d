"""Data parallelism across cards: train steps on R nccl ranks, one a card,
against the one-process step on one card.

    python3 -m caspr_tpu_torch.checks.parallel_cards [R]    (R cards, default 4)

Run from the root of a checkout (it reads chip_smoke.py's phase 10 batch
and comparison).  From the demo weights, Adam at 1e-4, injected noise:

  1. phase 10's global batch of 4 sequences x 5 frames x 1024 points, on R
     ranks (4 / R rows each) and in one process on card 0, with the
     continuous adjoint and with the discrete backward: one JSON line each
     with phase 10 (a)'s comparison (NFE, loss, gradients, the ranks'
     parameters bit-equal), the seconds of the step on each rank and in
     one process, and the collectives of the step;
  2. weak scaling: 4 rows a rank (a global batch of 4R) on R ranks against
     4 rows in one process, each step run twice and the second timed.

Every rank and the one-process side run each step once before the timed
one (the first carries the process's warm-up and nccl's first
collective).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import torch


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("parallel_cards: no CUDA device", file=sys.stderr)
        return 2
    ranks = int(argv[0]) if argv else 4
    if torch.cuda.device_count() < ranks:
        print(f"parallel_cards: {ranks} ranks need {ranks} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    from ..ops import kernels
    from .ranks import run_ranks

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    card = cs.card_line()
    print(card, flush=True)
    floor = cs.train_step_floor(torch)
    x, target, noise = cs.parallel_step_input()
    cs.one_process_steps(torch, x, target, noise)  # warm-up
    one = cs.one_process_steps(torch, x, target, noise)
    big = cs.parallel_step_input(4 * ranks)
    small = (big[0][:4], big[1][:4], big[2][:4 * cs.TRAIN_T])  # the first 4 rows
    cs.one_process_steps(torch, *small)
    one_small = cs.one_process_steps(torch, *small)
    torch.cuda.empty_cache()
    case = {"optimizer": "adam", "lr": cs.PAR_LR}
    cases = [dict(case, x=x, target=target, e=noise)] * 2 + [
        dict(case, x=x, target=target, e=noise, ode_backward="discrete")] + [
        dict(case, x=big[0], target=big[1], e=big[2])] * 2
    with tempfile.TemporaryDirectory() as work:
        start = time.perf_counter()
        results = run_ranks(ranks, {"job": "steps", "backend": "nccl", "device": "cuda",
                                    "weights": "demo", "cases": cases, "timeout": 300},
                            work, timeout=900)
        seconds = time.perf_counter() - start
    label = f"train step, {ranks} nccl ranks on {ranks} cards against one process on one card"
    for i, backward in ((1, "adjoint"), (2, "discrete")):
        cs.compare_parallel_step([r[i] for r in results], one[backward], floor, backward, label)
    scaled = [r[4] for r in results]
    nfe_equal = all(r["metrics"]["nfe"] == scaled[0]["metrics"]["nfe"] for r in scaled)
    print(json.dumps({
        "parallel": f"weak scaling: 4 rows a rank on {ranks} nccl ranks against 4 rows in one "
                    "process", "card": card, "global_batch": 4 * ranks,
        "step_seconds": {"ranks": [r["seconds"] for r in scaled],
                         "one_process": one_small["adjoint"][2]},
        "nfe": scaled[0]["metrics"]["nfe"], "nfe_one_process_4_rows": one_small["adjoint"][0]["nfe"],
        "nfe_equal_on_every_rank": nfe_equal, "collectives_per_step": scaled[0]["collectives"],
        "seconds": seconds}), flush=True)
    return 0 if nfe_equal else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
