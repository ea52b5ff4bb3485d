"""Host and device time of the CNF VJP wrapper and of the train step.

    python3 -m caspr_tpu_torch.checks.train_step_timing      (needs a CUDA card)

Run from the root of a checkout (it reads chip_smoke.py's train batches), it
prints three JSON lines: the VJP wrapper at the training path's shapes
(25 clouds of 1024 points, H = 512, random weights) -- host milliseconds
to enqueue a call and wall milliseconds a call over 20 calls; four train
steps at 5 x 5 x 1024 from caspr_init (seed 0) with chip_smoke.py phase 6's
batches, each timed on the host clock between synchronisations, with the
last step's NFE; and the fifteen operators with the most host time in one
more step under torch.profiler.  To compare two commits, run it from both
checkouts in one call, in the order parent, change, change, parent: the
step is host-bound, so its wall moves with the host's load.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("train_step_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    from ..models.caspr import CaSPRConfig, CaSPRModel, caspr_init
    from ..ops import kernels
    from ..train import make_optimizer, make_train_step

    kernels.build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bt, n, h = 25, 1024, 512
    rand = lambda *shape: torch.randn(shape, generator=g, device=dev)
    args = (rand(bt, n, 3), rand(bt, n, 3), torch.rand((bt, 8, h), generator=g, device=dev),
            rand(h, 3), rand(2, h, h) / 22.6, rand(3, h) / 22.6, rand(bt, n, 3), rand(bt, n))
    for _ in range(3):
        kernels.cnf_dynamics_vjp(*args)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(20):
        kernels.cnf_dynamics_vjp(*args)
    enqueued = time.perf_counter() - start
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    print(json.dumps({"checkout": os.getcwd(), "vjp_enqueue_ms_per_call": enqueued / 20 * 1e3,
                      "vjp_wall_ms_per_call": wall / 20 * 1e3}), flush=True)

    cfg = CaSPRConfig()
    model = CaSPRModel(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params, state = caspr_init(gen, cfg, device=dev)
    tx = make_optimizer(1e-4)
    opt = tx.init(params)
    step = make_train_step(model, tx, 0.01, 100.0)
    loader = chip_smoke.TrainLoader(4, 4)
    seconds = []
    for batch in loader.batches:
        torch.cuda.synchronize()
        start = time.perf_counter()
        params, opt, state, metrics = step(params, opt, state, batch["input"], batch["target"], gen)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
    print(json.dumps({"train_step_s": seconds, "nfe": metrics["nfe"]}), flush=True)
    batch = loader.batches[-1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, opt, state, batch["input"], batch["target"], gen)
        torch.cuda.synchronize()
    top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:15]
    print(json.dumps({"host_top": [(e.key[:60], e.self_cpu_time_total / 1e3, e.count)
                                   for e in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
