"""Device milliseconds a training step in NCCL's kernels on rank 0: the
summed trace time of the kernels whose name holds "nccl" in the traced
steps, over the steps.  The process group's annotations that torch lays
over the device timeline beside them ("nccl:all_reduce", ...) are not
kernels and are left out.  A collective's kernel also waits there for the
last rank to reach it.  None without such a kernel."""


def read(r):
    if r.trace is None or r.trace.calls == 0:
        return None
    found = [k for k in r.trace.kernels(("nccl",)) if not k[0].startswith("nccl:")]
    if not found:
        return None
    return 1000.0 * sum(e - s for _, s, e in found) / r.trace.calls
