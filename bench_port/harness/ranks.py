"""A cell on several cards: one process a card (a rank), as the port's data
parallelism runs (``caspr_tpu_torch/checks/ranks.py::run_ranks``).

``run.py`` builds the port's kernel library once, then ``launch`` starts
``run.py --rank <r> <work>`` for each card with RANK, WORLD_SIZE, LOCAL_RANK
and LOCAL_WORLD_SIZE set; the ranks meet through a FileStore in a work
directory under TMPDIR (no network port) and join one process group, nccl
on the cards.  Every rank builds the cell's driver and makes the same calls
in lockstep (``Team``); rank 0 alone keeps the host clock for the window and
for ``setup_s`` (from the launcher's start: ``time.perf_counter`` is the
system's monotonic clock), decides when the window ends and tells the others
by one small collective after each call's latency is taken, traces its calls,
runs the check once every rank has freed its state, and hands the result to
the launcher, which prints it once every rank has ended well.  A rank that
fails, ends before its run does or outlasts the deadline ends the run: the
launcher kills the others, prints each rank's last output on standard error
and no result, and exits with the failed rank's code (1 where it had none).
"""

from __future__ import annotations

import ctypes
import datetime
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# seconds a rank's collective may wait for the others before it fails
COLLECTIVE_TIMEOUT = 240
# seconds past --seconds within which every rank of a run has to end,
# counted from the end of the kernel build
RUN_ALLOWANCE = 270


class Solo:
    """The one process of a cell on one card: its own decisions."""

    lead = True

    def agree(self, done: bool) -> bool:
        return done

    def largest(self, value):
        return value

    def barrier(self):
        pass

    def close(self):
        pass


class Team:
    """This rank among a cell's ranks.  Rank 0 leads; a decision or a
    largest value is one collective of one element on the rank's device."""

    def __init__(self, rank: int, world: int, device):
        self.rank, self.world, self.device = rank, world, device
        self.lead = rank == 0

    def agree(self, done: bool) -> bool:
        """Rank 0's ``done``, on every rank."""
        import torch
        import torch.distributed as dist

        flag = torch.tensor([int(done)], dtype=torch.int32, device=self.device)
        dist.broadcast(flag, 0)
        return bool(flag.item())

    def largest(self, value):
        """The largest of the ranks' ``value`` (an int or a float)."""
        import torch
        import torch.distributed as dist

        dtype = torch.int64 if isinstance(value, int) else torch.float64
        t = torch.tensor([value], dtype=dtype, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t.item()

    def barrier(self):
        self.largest(0)

    def close(self):
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def _die_with_parent():
    """In a rank, before it runs: end it when the launcher ends, however."""
    if sys.platform.startswith("linux"):
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG


def _tails(work: Path, world: int) -> str:
    out = []
    for r in range(world):
        log = work / f"rank{r}.log"
        out.append(f"--- rank {r}:\n" + (log.read_text(errors="replace")[-3000:]
                                         if log.exists() else "(no output)"))
    return "\n".join(out)


def _wait(procs, work: Path, timeout: float):
    """None once every rank has ended well, else (reason, exit code)."""
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        for r, code in enumerate(codes):
            if code == 0 and not (work / f"rank{r}.done").exists():
                return f"rank {r} exited 0 before its run ended", 1
            if code:
                return f"rank {r} exited {code}", code
        if None not in codes:
            return None
        if time.monotonic() > deadline:
            running = [r for r, code in enumerate(codes) if code is None]
            return f"ranks {running} still running after {timeout:.0f} s", 1
        time.sleep(0.1)


def run_ranks(job: dict, script: Path, timeout: float):
    """Run ``job`` on ``job["world"]`` ranks, each ``script --rank <r>
    <work>`` from the checkout's root: (rank 0's output, None) where every
    rank ended well, else (None, exit code) after printing why on standard
    error."""
    world = job["world"]
    with tempfile.TemporaryDirectory(prefix="bench_ranks_") as tmp:
        work = Path(tmp)
        (work / "job.json").write_text(json.dumps(job))
        procs, logs = [], []
        previous = signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
        try:
            for r in range(world):
                logs.append(open(work / f"rank{r}.log", "w"))
                env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                           LOCAL_WORLD_SIZE=str(world))
                procs.append(subprocess.Popen(
                    [sys.executable, str(script), "--rank", str(r), str(work)],
                    cwd=script.parent.parent, env=env, stdout=logs[-1], stderr=subprocess.STDOUT,
                    preexec_fn=_die_with_parent))
            failure = _wait(procs, work, timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in logs:
                f.close()
            signal.signal(signal.SIGTERM, previous)
        if failure is not None:
            reason, code = failure
            print(f"{reason}\n{_tails(work, world)}", file=sys.stderr)
            return None, code
        return json.loads((work / "out.json").read_text()), None


def build_kernels(device: str):
    """The port's kernel library, built once before the ranks start (each
    rank loads it)."""
    if device == "cuda":
        from caspr_tpu_torch.ops import kernels

        kernels.build()


def launch(args, cell, bench: Path, start: float, device: str = "cuda", fault: str | None = None,
           timeout: float | None = None):
    """One run of a cell on ``cell.chips`` ranks: (rank 0's {"result",
    "table"}, None), or (None, exit code) where a rank failed.  ``fault``
    names a fault of ``harness/faults.py`` planted in every rank's driver."""
    build_kernels(device)
    job = {"args": vars(args), "start": start, "device": device,
           "backend": "nccl" if device == "cuda" else "gloo", "world": cell.chips,
           "fault": fault, "timeout": COLLECTIVE_TIMEOUT}
    return run_ranks(job, bench / "run.py",
                     args.seconds + RUN_ALLOWANCE if timeout is None else timeout)


def rank_device(name: str, rank: int):
    """The rank's device: its card (``cuda:<rank>``, made current) or the CPU."""
    import torch

    if name == "cpu":
        return torch.device("cpu")
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    return device


def rank_main(rank: int, work: Path, run) -> int:
    """A rank: join the group and ``run(job, team, device)``, rank 0 writing
    what it returns for the launcher.  One CPU thread a rank, as torchrun
    gives each of its processes."""
    import torch
    import torch.distributed as dist

    from harness import core

    job = json.loads((work / "job.json").read_text())
    world = job["world"]
    torch.set_num_threads(1)
    device = rank_device(job["device"], rank)
    dist.init_process_group(job["backend"], store=dist.FileStore(str(work / "store"), world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=job["timeout"]))
    team = Team(rank, world, device)
    try:
        out = run(job, team, device)
    except core.ForbiddenImport as exc:
        print(f"forbidden import: {exc}", file=sys.stderr)
        return 3
    finally:
        team.close()
    if team.lead:
        tmp = work / "out.json.tmp"
        tmp.write_text(json.dumps(out))
        os.replace(tmp, work / "out.json")
    (work / f"rank{rank}.done").touch()
    return 0
