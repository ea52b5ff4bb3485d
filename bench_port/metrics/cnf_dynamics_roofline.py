"""cnf_dynamics's share of its roofline in the traced steps: the least time
of the likelihood's field-and-tangent evaluations (each step's forward and
backward CNF NFE x the work over every point, harness/flops.py) over the
summed time of the kernels named below and of the weight preparation
launched just before each (harness/trace.py)."""

from harness import flops, peaks

KERNELS = ("cnf_dynamics_kernel", "cnf_dynamics_bf16_kernel")


def read(r):
    if r.trace is None:
        return None
    busy = sum(e - s for _, s, e in r.trace.wrapper_kernels(KERNELS))
    if busy <= 0:
        return None
    t, m = r.cell.traffic, r.cell.model
    least = 0.0
    for info in r.trace.results:
        evals = info["nfe"][1] + info["nfe_bwd"][1]
        least += evals * peaks.roofline_s(*flops.cnf_work(m, info["seqs"] * t["seq_len"],
                                                          t["points"], 2))
    return 100.0 * least / busy
