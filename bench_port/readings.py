"""The readings that a cell's correctness limits are set from, in one process:
for each seed, the program's compared numbers against the plain reference
(the lower reading: sound runs), and on the control seeds the control's,
the reference in the nearest precision below the configuration's (float32
products in TF32) put in the program's place (the upper reading), and for
a training cell the program with half of each batch left out and with the
CNF's field weights given a zero gradient.

    python3 bench_port/readings.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--look-seeds 7] [--out readings_<cell>.jsonl]

Prints one JSON line per seed and reading.  Not part of a run: the limits
in traffic/<cell>.json and PERF.md come from its output.  A training cell
on several cards runs on its ranks (``harness/ranks.py``): every rank takes
the program's first steps, rank 0 compares them, and on a control seed also
the control and the program with each of ``RANK_FAULTS`` planted, each
with its ``ranks_gap``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for _path in (str(BENCH.parent), str(BENCH)):
    if _path not in sys.path:
        sys.path.insert(0, _path)

from harness import core, faults, program, ranks, sequences  # noqa: E402

# the faults read on a control seed of a training cell on several cards
RANK_FAULTS = ("half_batch", "cnf_grad_zeroed", "gradient_not_reduced")
# seconds a collective of the readings' ranks may wait (rank 0's reference)
READINGS_COLLECTIVE_TIMEOUT = 900


def eval_readings(torch, driver, cell, seed, control, device):
    """Numbers of the program and (when ``control``) of the control on
    ``check_calls`` entries of the seed's pool, the worst over them."""
    pool_seed, weight_seed, _ = core.seeds(seed, 3)
    driver.pool = sequences.make_pool(program.generator(device, pool_seed), cell.traffic, device)
    driver.weight_seed = weight_seed
    driver.params, driver.state = program.weights(cell, driver.model.cfg, device, weight_seed)
    ref_params, ref_state = program.reference_weights(cell, device, weight_seed)
    driver.ref_params, driver.ref_state = ref_params, ref_state
    out = {"program": {}, "control": {}}
    for j in range(cell.traffic["check_calls"]):
        info = driver.call(j)
        outputs = info.pop("outputs")
        ref_outputs, ref_nfe = driver.reference(j)
        for k, v in driver.compare(outputs, info.get("nfe"), ref_outputs, ref_nfe).items():
            out["program"][k] = max(out["program"].get(k, 0.0), v)
        if control:
            ctl_outputs, ctl_nfe = driver.reference(j, tf32=True)
            for k, v in driver.compare(ctl_outputs, ctl_nfe, ref_outputs, ref_nfe).items():
                out["control"][k] = max(out["control"].get(k, 0.0), v)
    return out


def worst(gaps, count=3):
    """The widest leaf gaps, by leaf name."""
    return sorted(([n, g] for n, g in gaps.items()), key=lambda row: -row[1])[:count]


def leaf_look(gaps, group_of, losses=None):
    """The worst leaves of a gap table, over all and by group, and how many
    read over 1%."""
    groups = {}
    for n, g in gaps.items():
        groups.setdefault(group_of(n), {})[n] = g
    out = {"worst": worst(gaps), "by_group": {k: worst(v, 1) for k, v in groups.items()},
           "over_1pct": sum(v > 0.01 for v in gaps.values()), "leaves": len(gaps)}
    if losses is not None:
        out["losses"] = losses
    return out


def flips(tape, other):
    """Per max-pool of the reference's encoder, the share of its winners
    (argmax entries) that differ between two runs of the same steps."""
    out = {}
    for (label, a), (_, b) in zip(tape, other):
        moved, total = out.get(label, (0, 0))
        out[label] = (moved + int((a != b).sum()), total + a.numel())
    return {label: moved / total for label, (moved, total) in out.items()}


def train_readings(torch, module, cell, seed, control, device, look=False):
    """The lower reading (the program against the reference) and, on a
    control seed, the upper ones: the control, half of each batch left out
    and the CNF's field weights given a zero gradient.  With ``look``, the
    reference against itself with its inputs moved by one unit in the last
    place, and how many max-pool winners that moves."""
    from reference import caspr as ref

    pool_seed, weight_seed, _ = core.seeds(seed, 3)

    def program_run(fault=None):
        driver = module.Driver(cell, device, pool_seed, weight_seed)
        if fault is not None:
            fault(driver)
        driver.warm()
        driver.release()
        torch.cuda.empty_cache()
        return driver

    def against(run, reference):
        grad, moved, losses = driver.leaf_gaps(*run, *reference)
        return {"grad": leaf_look(grad, module.group_of, losses),
                "change": leaf_look(moved, module.group_of)}

    driver = program_run()
    ref.TAPE = [] if look else None
    reference = driver.reference()
    tape, ref.TAPE = ref.TAPE, None
    mine = (driver.first, driver.grads, driver.change)
    out = {"program": driver.compare(*mine, *reference), "look": against(mine, reference)}
    if control:
        control_run = driver.reference(tf32=True)
        out["control"] = driver.compare(*control_run, *reference)
        out["control_look"] = against(control_run, reference)
        for name in ("half_batch", "cnf_grad_zeroed"):
            faulty = program_run(faults.FAULTS[name])
            out[name] = faulty.compare(faulty.first, faulty.grads, faulty.change, *reference)
    if look:
        pool = driver.pool
        driver.pool = [{**e, "input": torch.nextafter(e["input"], torch.full_like(
            e["input"], float("inf")))} for e in pool]
        ref.TAPE = []
        moved_run = driver.reference()
        out["rounding"] = driver.compare(*moved_run, *reference)
        out["rounding_look"] = against(moved_run, reference)
        out["rounding_flips"] = flips(tape, ref.TAPE)
        ref.TAPE, driver.pool = None, pool
    return out


def rank_readings(job, team, device):
    """A rank's part of a training cell's readings on several cards: rank
    0's rows, each also appended to ``job["out"]`` as it comes."""
    import torch

    cell = core.load_cell(job["workload"], BENCH)
    module = core.load_module(BENCH / "drivers" / f"{cell.traffic['driver']}.py", "driver")
    on_card = torch.device(device).type == "cuda"
    rows = []
    for seed in job["seeds"]:
        start = time.perf_counter()
        control = seed in job["control_seeds"]
        pool_seed, weight_seed, _ = core.seeds(seed, 3)
        runs = {}
        for name in (None,) + (RANK_FAULTS if control else ()):
            driver = module.Driver(cell, device, pool_seed, weight_seed)
            if name is not None:
                faults.FAULTS[name](driver)
            driver.warm()
            driver.close_window()
            driver.release()
            if on_card:
                torch.cuda.empty_cache()
            runs[name] = driver
        team.barrier()
        if team.lead:
            sound = runs[None]
            reference = sound.reference()
            mine = (sound.first, sound.grads, sound.change)
            grad, moved, losses = sound.leaf_gaps(*mine, *reference)
            row = {"program": {**sound.compare(*mine, *reference), "ranks_gap": sound.ranks_gap},
                   "look": {"grad": leaf_look(grad, module.group_of, losses),
                            "change": leaf_look(moved, module.group_of)}}
            if control:
                row["control"] = sound.compare(*sound.reference(tf32=True), *reference)
                for name in RANK_FAULTS:
                    f = runs[name]
                    row[name] = {**f.compare(f.first, f.grads, f.change, *reference),
                                 "ranks_gap": f.ranks_gap}
            row.update(workload=job["workload"], seed=seed, seconds=time.perf_counter() - start)
            if job["out"]:
                with open(job["out"], "a") as sink:
                    sink.write(json.dumps(row) + "\n")
            rows.append(row)
        team.barrier()  # the other ranks wait for rank 0's reference
    return rows


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank"]:
        return ranks.rank_main(int(argv[1]), Path(argv[2]), rank_readings)
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--look-seeds", type=int, nargs="*", default=[],
                   help="training: also the reference against itself with its inputs "
                        "moved by one unit in the last place")
    p.add_argument("--out", default=None)
    p.add_argument("--timeout", type=float, default=3000.0,
                   help="a cell on several cards: seconds within which every rank has to end")
    args = p.parse_args(argv)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = core.load_cell(args.workload, BENCH)
    if cell.chips > 1:
        ranks.build_kernels(device)
        job = {"workload": args.workload, "device": device,
               "seeds": list(dict.fromkeys(args.seeds + args.control_seeds)),
               "control_seeds": args.control_seeds,
               "out": str(Path(args.out).resolve()) if args.out else None,
               "backend": "nccl" if device == "cuda" else "gloo", "world": cell.chips,
               "timeout": READINGS_COLLECTIVE_TIMEOUT}
        rows, code = ranks.run_ranks(job, BENCH / "readings.py", args.timeout)
        for row in rows or []:
            print(json.dumps(row), flush=True)
        return code or 0
    module = core.load_module(BENCH / "drivers" / f"{cell.traffic['driver']}.py", "driver")
    sink = open(args.out, "a") if args.out else None
    driver = None
    for seed in list(dict.fromkeys(args.seeds + args.control_seeds + args.look_seeds)):
        start = time.perf_counter()
        control = seed in args.control_seeds
        if cell.traffic["driver"] == "train_step":
            row = train_readings(torch, module, cell, seed, control, device,
                                 look=seed in args.look_seeds)
        else:
            if driver is None:
                driver = module.Driver(cell, device, *core.seeds(seed, 2))
                driver.warm()
            row = eval_readings(torch, driver, cell, seed, control, device)
        row.update(workload=args.workload, seed=seed, seconds=time.perf_counter() - start)
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    if sink:
        sink.close()


if __name__ == "__main__":
    sys.exit(main())
