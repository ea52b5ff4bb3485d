"""cnf_primal's share of its roofline in the traced calls: the least time of
the decode's CNF field evaluations (the traced calls' CNF NFE x the field's
work over every decoded point, harness/flops.py) over the summed time of
the kernels named below and of the weight preparation launched just
before each (harness/trace.py)."""

from harness import flops, peaks

KERNELS = ("cnf_primal_kernel", "cnf_primal_bf16_kernel")


def read(r):
    if r.trace is None:
        return None
    busy = sum(e - s for _, s, e in r.trace.wrapper_kernels(KERNELS))
    if busy <= 0:
        return None
    t, m = r.cell.traffic, r.cell.model
    least = 0.0
    for info in r.trace.results:
        clouds = info["seqs"] * t["frames"]
        least += info["nfe"][1] * peaks.roofline_s(*flops.cnf_work(m, clouds, t["points"], 1))
    return 100.0 * least / busy
