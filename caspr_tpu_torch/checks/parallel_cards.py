"""Data and point parallelism across cards: train steps and reconstructs
on R nccl ranks, one a card, against one process on one card.

    python3 -m caspr_tpu_torch.checks.parallel_cards [R] [--sp-size S]    (R cards, default 4)

Run from the root of a checkout (it reads chip_smoke.py's phase 10 and 11
batches and comparisons).  From the demo weights, Adam at 1e-4, injected
noise, without --sp-size (data parallelism, the (dp,) mesh):

  1. phase 10's global batch of 4 sequences x 5 frames x 1024 points, on R
     ranks (4 / R rows each) and in one process on card 0, with the
     continuous adjoint and with the discrete backward: one JSON line each
     with phase 10 (a)'s comparison (NFE, loss, gradients, the ranks'
     parameters bit-equal), the seconds of the step on each rank and in
     one process, and the collectives of the step;
  2. weak scaling: 4 rows a rank (a global batch of 4R) on R ranks against
     4 rows in one process, each step run twice and the second timed.

With --sp-size S (point parallelism):

  1. phase 10's global batch on the (dp R/S, sp S) mesh (1024 / S points a
     rank) against one process, the continuous adjoint: phase 11 (a)'s
     comparison at ``SP_CARDS_STEP_BARS``, the seconds and the collectives;
  2. one sequence's reconstruct, 10 frames x 2048 points, on the (dp 1, sp
     R) mesh (2048 / R points a rank) against one card: phase 11 (c)'s
     comparison (equal NFE, points within 1e-3) and the seconds of each.

Every rank and the one-process side run each step or reconstruct once
before the timed one (the first carries the process's warm-up and nccl's
first collective).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

# the (dp 2, sp 2) step's bars against one card (loss, flow or latent leaf
# of its largest, encoder relative L2): the sums over the dp ranks reorder
# as under data parallelism, 2.4e-8, 1.0e-5 (latent_ode.layer2.weight) and
# 2.5e-4 were read on four H100 80GB HBM3 at 700 W
SP_CARDS_STEP_BARS = (1e-6, 1e-4, 1e-3)


def sp_main(cs, ranks: int, sp: int, card: str) -> int:
    """The --sp-size checks (module docstring)."""
    from .ranks import run_ranks

    floor = cs.train_step_floor(torch)
    x, target, noise = cs.parallel_step_input()
    cs.one_process_steps(torch, x, target, noise)  # warm-up
    one = cs.one_process_steps(torch, x, target, noise)
    rx, rts, rbase = cs.sp_reconstruct_input(torch)
    rx, rbase = rx[:1], rbase[:1]  # one sequence
    one_recon = cs.one_process_reconstruct(torch, rx, rts, rbase)
    torch.cuda.empty_cache()
    case = {"optimizer": "adam", "lr": cs.PAR_LR, "x": x, "target": target, "e": noise}
    common = {"backend": "nccl", "device": "cuda", "weights": "demo", "timeout": 300}
    with tempfile.TemporaryDirectory() as work:
        start = time.perf_counter()
        steps = run_ranks(ranks, dict(common, job="steps", sp_size=sp, cases=[case] * 2),
                          os.path.join(work, "steps"), timeout=900)
        steps_seconds = time.perf_counter() - start
        start = time.perf_counter()
        recon = run_ranks(ranks, dict(common, job="reconstruct", sp_size=ranks, x=rx,
                                      timestamps=rts, base=rbase),
                          os.path.join(work, "reconstruct"), timeout=900)
        recon_seconds = time.perf_counter() - start
    dp = ranks // sp
    cs.compare_parallel_step([r[1] for r in steps], one["adjoint"], floor, "adjoint",
                             f"train step, (dp {dp}, sp {sp}) on {ranks} nccl ranks on {ranks} "
                             "cards against one process on one card", SP_CARDS_STEP_BARS)
    cs.compare_sp_reconstruct(recon, one_recon, f"reconstruct 1 x {cs.FRAMES} x {cs.POINTS}, "
                              f"(dp 1, sp {ranks}) on {ranks} nccl ranks on {ranks} cards "
                              "against one process on one card", card)
    slowest = max(r["seconds"] for r in recon)
    print(json.dumps({"parallel": "sp launches", "card": card,
                      "launch_seconds": {"steps": steps_seconds, "reconstruct": recon_seconds},
                      "sequences_per_s": {"ranks": 1.0 / slowest, "one_card": 1.0 / one_recon[2]}}),
          flush=True)
    return 0


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("parallel_cards: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(prog="parallel_cards")
    parser.add_argument("ranks", type=int, nargs="?", default=4)
    parser.add_argument("--sp-size", type=int, default=1)
    args = parser.parse_args(argv)
    ranks = args.ranks
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
    if args.sp_size != 1:
        if ranks % args.sp_size:
            print(f"parallel_cards: --sp-size {args.sp_size} does not divide {ranks} ranks",
                  file=sys.stderr)
            return 2
        return sp_main(cs, ranks, args.sp_size, card)
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
