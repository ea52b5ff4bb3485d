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

from harness import core  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(args, bench: Path = BENCH, device: str = "cuda", start: float = START,
             fault=None):
    """Set up, measure and check one cell: (result without "checks", checks
    table).  ``fault(driver)``, for tests, breaks the program before its first
    call."""
    import torch

    from harness import trace as tracing

    on_card = device == "cuda"
    cell = core.load_cell(args.workload, bench)
    pool_seed, weight_seed, sample_seed = core.seeds(args.seed, 3)
    module = core.load_module(bench / "drivers" / f"{cell.traffic['driver']}.py",
                              "bench_driver_" + cell.traffic["driver"])
    driver = module.Driver(cell, device, pool_seed, weight_seed)
    if fault is not None:
        fault(driver)
    driver.warm()
    spans = None
    if args.trace:
        spans = core.Spans(torch, on_card)
        for name, attr in driver.spans.items():
            spans.wrap(driver.model, attr, name)
    if on_card:
        torch.cuda.synchronize()
    core.guard("after set-up")
    setup_s = time.perf_counter() - start

    sample = core.Sample(cell.traffic["check_calls"], sample_seed)
    window, latencies, infos, failed = core.measure(torch, driver, args.seconds, sample, spans)
    core.guard("after the window")
    readings = core.Readings(cell, setup_s, window, latencies, infos,
                             spans.ms if spans is not None else {})
    if args.trace and on_card:
        readings.trace = tracing.record(torch, lambda j: driver.call(len(infos) + j),
                                        cell.traffic["trace_calls"])
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips,
                   "memory_peak_bytes": torch.cuda.max_memory_allocated() if on_card else 0}
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
    correct, table = core.judge(driver.check(sample))
    core.guard("before the result")
    return {"correct": correct, **result}, table


def main(argv=None) -> int:
    args = parse(argv)
    cell = core.load_cell(args.workload, BENCH)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        result, table = run_cell(args)
    except core.ForbiddenImport as exc:
        print(f"forbidden import: {exc}", file=sys.stderr)
        return 3
    core.emit(result, table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
