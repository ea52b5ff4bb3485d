"""One run of one cell of the benchmark of caspr_tpu_torch, the PyTorch and
CUDA port of CaSPR, on the NVIDIA H100s of this machine.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Makes the cell's weights and inputs from the
seed, sets up and warms up its entry (counted as ``setup_s``), calls it in a
closed loop for ``--seconds``, and with ``--trace 1`` also times its stages
and traces a few more calls with torch.profiler.  Then the program's state
is freed and the plain reference (``reference/``) recomputes a sample of the
window's answers drawn from the seed; ``correct`` says whether every
compared number lies within its limit.  The last line of standard output is
the result as one JSON object; the compared numbers and their limits are the
last lines of standard error.  Exits 2 without a result where CUDA or the
cell's cards are missing, 3 where JAX or the JAX package was loaded.

A cell on several cards runs as one process a card (``harness/ranks.py``):
this process builds the kernel library, starts the ranks as ``run.py --rank
<r> <work>`` and prints rank 0's result once every rank has ended well.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for _path in (str(ROOT), str(BENCH)):
    if _path not in sys.path:
        sys.path.insert(0, _path)
# build and kernel caches at fixed places inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(ROOT / ".bench_cache" / _sub)

from harness import core, ranks  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(args, bench: Path = BENCH, device="cuda", start: float = START, fault=None,
             team=None):
    """Set up, measure and check one cell: (result without "checks", checks
    table).  ``fault(driver)``, for tests, breaks the program before its first
    call.  ``team``: this rank among a cell's ranks (``harness/ranks.py``),
    which all make the same calls; rank 0 alone times, traces and checks, and
    the others return (None, None)."""
    import torch

    from harness import trace as tracing

    team = ranks.Solo() if team is None else team
    on_card = torch.device(device).type == "cuda"
    cell = core.load_cell(args.workload, bench)
    pool_seed, weight_seed, sample_seed = core.seeds(args.seed, 3)
    module = core.load_module(bench / "drivers" / f"{cell.traffic['driver']}.py",
                              "bench_driver_" + cell.traffic["driver"])
    driver = module.Driver(cell, device, pool_seed, weight_seed)
    if fault is not None:
        fault(driver)
    driver.warm()
    spans = None
    if args.trace and team.lead:
        spans = core.Spans(torch, on_card)
        for name, attr in driver.spans.items():
            spans.wrap(driver.model, attr, name)
    if on_card:
        torch.cuda.synchronize()
    team.barrier()
    core.guard("after set-up")
    setup_s = time.perf_counter() - start

    sample = core.Sample(cell.traffic["check_calls"], sample_seed)
    window, latencies, infos, failed = core.measure(torch, driver, args.seconds, sample, spans,
                                                    team.agree)
    core.guard("after the window")
    readings = core.Readings(cell, setup_s, window, latencies, infos,
                             spans.ms if spans is not None else {})
    if args.trace and on_card:
        call = lambda j: driver.call(len(infos) + j)  # noqa: E731
        if team.lead:
            readings.trace, readings.counters = record(torch, tracing, driver, call,
                                                       cell.traffic["trace_calls"])
        else:
            for j in range(cell.traffic["trace_calls"]):
                call(j)
    peak = team.largest(torch.cuda.max_memory_allocated() if on_card else 0)
    if hasattr(driver, "close_window"):
        driver.close_window()
    if not team.lead:
        driver.release()
        team.barrier()
        team.close()
        return None, None
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak}
    metrics = core.read_metrics(cell.per_layer if args.trace else cell.end_to_end, readings)
    result = {"attempted": len(infos), "failed": failed, "metrics": metrics,
              "device": device_info}
    if readings.trace is not None:
        device_info["busy_s"] = readings.trace.busy_s()
        device_info["window_s"] = readings.trace.window_s
        result["breakdown"] = {"device_ops": [list(kv) for kv in readings.trace.top_ops()],
                               "idle_gaps": [list(kv) for kv in readings.trace.idle_by_host()]}
        readings.trace = None
    driver.release()
    if on_card:
        torch.cuda.empty_cache()
    team.barrier()  # every rank has freed its state
    team.close()
    correct, table = core.judge(driver.check(sample))
    core.guard("before the result")
    return {"correct": correct, **result}, table


def record(torch, tracing, driver, call, calls: int):
    """(trace, program counters) of ``calls`` traced calls; the counters of a
    driver that reads some (``reset_counters``, ``counters``) are reset just
    before the calls and read just after."""
    counted = hasattr(driver, "counters")
    if counted:
        driver.reset_counters()
    trace = tracing.record(torch, call, calls)
    return trace, driver.counters() if counted else {}


def run_rank(job, team, device):
    """A rank's part of a run (``harness/ranks.py``): rank 0's result."""
    from harness import faults

    fault = faults.FAULTS[job["fault"]] if job["fault"] else None
    result, table = run_cell(argparse.Namespace(**job["args"]), device=device, start=job["start"],
                             fault=fault, team=team)
    return {"result": result, "table": table}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank"]:
        return ranks.rank_main(int(argv[1]), Path(argv[2]), run_rank)
    args = parse(argv)
    cell = core.load_cell(args.workload, BENCH)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        if cell.chips > 1:
            out, code = ranks.launch(args, cell, BENCH, START)
            if out is None:
                return code
            result, table = out["result"], out["table"]
            core.guard("before the result")
        else:
            result, table = run_cell(args)
    except core.ForbiddenImport as exc:
        print(f"forbidden import: {exc}", file=sys.stderr)
        return 3
    core.emit(result, table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
