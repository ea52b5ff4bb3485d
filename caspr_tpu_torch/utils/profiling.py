"""Profiling helpers (counterpart of caspr_tpu/utils/profiling.py): a
device trace through torch.profiler, a wall-clock scope, and named ranges
that show up in the trace and, on the card, as NVTX ranges."""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block's host and card activity with torch.profiler and
    write its Chrome trace (chrome://tracing, Perfetto) to
    ``log_dir/trace_<time>_<pid>.json``.  Yields the profiler, whose
    ``key_averages()`` sum the block's time by operator and kernel; on the
    card the block's queued work is waited for before the trace ends."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"))


@contextlib.contextmanager
def wallclock(name: str, sink=print):
    start = time.perf_counter()
    try:
        yield
    finally:
        sink(f"[{name}] {time.perf_counter() - start:.3f}s")


@contextlib.contextmanager
def annotate(name: str):
    """Named region that shows up in device traces (a torch.profiler
    record_function and, where CUDA is present, an NVTX range)."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
