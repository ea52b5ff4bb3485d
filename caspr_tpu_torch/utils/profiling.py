"""Profiling helpers (counterpart of caspr_tpu/utils/profiling.py): a
device trace through torch.profiler, a wall-clock scope, and ``annotate``,
the program's span function.

Spans are on exactly while a torch.profiler (or torch.autograd.profiler)
profile records: ``annotate(name)`` is then a function-scope RecordFunction,
which the profiler keeps as a host event on the clock of the device activity
it traces, and which leaves with the profiler's trace.  It is not a
``record_function`` (a user annotation): the profiler lays a user
annotation over the device timeline too, as an event beside the kernels
launched inside it, and a trace's device operations would then count each
span.  With no profile recording, ``annotate`` is one shared null context.
The program's spans, each ``caspr::<boundary>``:

  - ``caspr::train_step`` (one call of ``train.loop.make_train_step``'s
    step) and its stages ``.forward``, ``.backward`` and ``.update``;
  - ``caspr::encode``, ``caspr::latent``, ``caspr::decode`` and
    ``caspr::likelihood``: the model's layers (``models.caspr``);
  - ``caspr::adjoint`` (one backward of ``ops.odeint.odeint_adjoint``) and
    ``caspr::adjoint.interval`` (one augmented solve between two request
    times);
  - ``caspr::ode.solve`` (one dopri5 solve), ``caspr::ode.step`` (one
    attempted step, its stages to its next step size),
    ``caspr::ode.dense`` (a step's dense output at the request times it
    reaches) and ``caspr::ode.func`` (one evaluation of the dynamics);
  - ``caspr::host_read``: one device-to-host read, a synchronisation.

The counts of these spans in a trace are the program's counters: nothing
is counted on the host besides."""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd import profiler as _profiler


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


# the span of every call made while no profiler records
_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A span named ``name`` in the trace of the profiler that is recording
    (a host event, module docstring), or, with none, a shared null context
    that records nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)
