"""The cell-independent part of a run: finding a cell's files by name, the
import guard, spans, the measured window, the sample of answers kept for the
check, and the result line.

A cell is an entry of ``workloads`` in BENCHMARK.json.  Everything that
belongs to one configuration, traffic mix, entry or metric is a file of its
own, found by the name BENCHMARK.json gives:

    <bench>/traffic/<traffic>.json   the mix: its driver, shapes, pool, limits
    <bench>/drivers/<driver>.py      the entry: set-up, one call, the check
    <bench>/metrics/<metric>.py      one metric: read(readings) -> value or None
    the configuration's "file"       sizes, solver, precision, weights
    <bench>/reference/<module>.py    the plain reference that the file's
                                     "reference" names (default "caspr")
"""

from __future__ import annotations

import importlib.util
import json
import math
import random
import re
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "caspr_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is that of JAX or of the JAX
    package, compared whole (the port's name begins with the latter's)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


class ForbiddenImport(RuntimeError):
    pass


def guard(stage: str):
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"{stage}: loaded {', '.join(found)}")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the reference a configuration file names where it names none
DEFAULT_REFERENCE = "caspr"


def load_reference(name: str, bench: Path):
    """The plain reference module ``<bench>/reference/<name>.py``, as the
    module ``reference.<name>`` (so that its relative imports, such as
    caspr's solver, resolve in its folder): the imported one where that is
    this file, else the file itself (a copy of the benchmark off the path)."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"reference module {name!r} is not a module name")
    path = (bench / "reference" / f"{name}.py").resolve()
    qualified = f"reference.{name}"
    try:
        module = importlib.import_module(qualified)
        if Path(module.__file__).resolve() == path:
            return module
    except ModuleNotFoundError:
        pass
    return load_module(path, qualified)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    bench: Path  # the benchmark's folder
    root: Path  # the checkout
    reference: object  # the configuration's reference module

    @property
    def model(self):
        """The model and solver sections of the configuration, merged."""
        return {**self.config["model"], **self.config["solver"]}


def load_cell(name: str, bench: Path) -> Cell:
    root = bench.parent
    spec = json.loads((root / "BENCHMARK.json").read_text())
    (work,) = [w for w in spec["workloads"] if w["name"] == name]
    (conf,) = [c for c in spec["configs"] if c["name"] == work["config"]]
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    config = json.loads((root / conf["file"]).read_text())
    cell = Cell(name, work["chips"], config,
                json.loads((bench / "traffic" / f"{work['traffic']}.json").read_text()),
                e2e, layer, bench, root,
                load_reference(config.get("reference", DEFAULT_REFERENCE), bench))
    cell.reference.check_model(cell.model)
    return cell


def seeds(seed: int, count: int):
    """``count`` independent 63-bit seeds derived from the run's seed."""
    state = np.random.SeedSequence(seed % 2**128).generate_state(count, np.uint64)
    return [int(s) >> 1 for s in state]


class Spans:
    """Per-call durations of named stages, in ms: CUDA events on the card
    (device time between the stage's first and last queued work, idle gaps
    included), the host clock on the CPU.  Installed by wrapping methods of
    the program's objects; the program is not edited."""

    def __init__(self, torch, on_card: bool):
        self.torch, self.on_card = torch, on_card
        self.pending, self.ms = [], {}

    def wrap(self, obj, attr: str, name: str):
        inner = getattr(obj, attr)

        def timed(*args, **kwargs):
            if self.on_card:
                start, end = (self.torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = inner(*args, **kwargs)
                end.record()
            else:
                start = time.perf_counter()
                out = inner(*args, **kwargs)
                end = time.perf_counter()
            self.pending.append((name, start, end))
            return out

        setattr(obj, attr, timed)

    def collect(self):
        """Fold the finished call's stages in (after its synchronisation)."""
        totals = {}
        for name, start, end in self.pending:
            ms = start.elapsed_time(end) if self.on_card else (end - start) * 1e3
            totals[name] = totals.get(name, 0.0) + ms
        for name, ms in totals.items():
            self.ms.setdefault(name, []).append(ms)
        self.pending.clear()


class Sample:
    """A sample of the window's answers, drawn from the seed as they come
    (reservoir sampling): (call index, the call's info, its outputs)."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.kept = size, random.Random(seed), []

    def offer(self, index, info, outputs):
        if not outputs:
            return
        if len(self.kept) < self.size:
            self.kept.append((index, info, [o.clone() for o in outputs]))
            return
        j = self.rng.randrange(index + 1)
        if j < self.size:
            self.kept[j] = (index, info, [o.clone() for o in outputs])


@dataclass
class Readings:
    """What the metric readers read."""

    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    latencies_s: list = field(default_factory=list)
    infos: list = field(default_factory=list)  # each call's info from the driver
    spans_ms: dict = field(default_factory=dict)
    trace: object = None  # harness.trace.Trace of the traced calls, when taken
    counters: dict = field(default_factory=dict)  # the program's counters over them

    @property
    def calls(self):
        return len(self.infos)

    @property
    def seqs(self):
        return sum(info["seqs"] for info in self.infos)


def measure(torch, driver, seconds: float, sample: Sample, spans: Spans | None, agree=bool):
    """Calls in a closed loop until ``seconds`` have passed; each call ends
    synchronised.  ``agree(done)`` makes the decision to stop one for all
    the ranks of a cell on several cards (rank 0's), after a call's latency
    is taken.  Returns (window seconds, latencies, infos, failed calls:
    those with an output that is not finite)."""
    latencies, infos, finite = [], [], []
    start = time.perf_counter()
    index = 0
    while True:
        t0 = time.perf_counter()
        info = driver.call(index)
        t1 = time.perf_counter()
        outputs = info.pop("outputs", ())
        if spans is not None:
            spans.collect()
        if outputs:
            finite.append(torch.stack([torch.isfinite(o).all() for o in outputs]).all())
        sample.offer(index, info, outputs)
        latencies.append(t1 - t0)
        infos.append(info)
        index += 1
        if agree(t1 - start >= seconds):
            break
    window = t1 - start
    failed = sum(not bool(f) for f in finite)
    return window, latencies, infos, failed


def read_metrics(entries, readings: Readings):
    """{name: {"value", "unit"}} of the metrics whose reader finds something."""
    out = {}
    for entry in entries:
        path = readings.cell.bench / "metrics" / f"{entry['name']}.py"
        reader = load_module(path, "bench_metric_" + entry["name"].replace(".", "_"))
        value = reader.read(readings)
        if value is not None:
            if not math.isfinite(value):
                raise ValueError(f"metric {entry['name']} read {value}")
            out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


def sample_checks(driver, sample: Sample, limits: dict):
    """(name, value, limit) of an evaluation driver's numbers, each the worst
    over the sampled answers recomputed by its reference."""
    worst = {}
    for _, info, outputs in sample.kept:
        ref_outputs, ref_nfe = driver.reference(info["entry"])
        for k, v in driver.compare(outputs, info.get("nfe"), ref_outputs, ref_nfe).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return [(k, worst[k], limits[k]) for k in limits]


def judge(checks):
    """(correct, {name: {"value", "limit"}}) of (name, value, limit) triples:
    correct when every value is finite and at most its limit."""
    table = {name: {"value": float(v), "limit": float(lim)} for name, v, lim in checks}
    correct = bool(checks) and all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    return correct, table


def emit(result: dict, checks_table: dict):
    """The result line last on standard output; the compared numbers beside
    their limits last on standard error."""
    for name, row in checks_table.items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks_table}), flush=True)
