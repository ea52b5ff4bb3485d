"""cnf_dynamics_vjp's share of its roofline in the traced steps: the least
time of the adjoint's VJPs of the field and its tangent (the backward CNF
NFE but the two plain evaluations at the interval's ends, x the backward's
work over every point, harness/flops.py) over the summed time of the VJP's
kernels named below and of the weight preparation launched just before
them (harness/trace.py)."""

from harness import flops, peaks

KERNELS = ("vjp_tile_kernel", "wgrad_tc_kernel", "thin_grad_kernel", "finalize_kernel",
           "vjp_bf16_kernel", "wgrad_bf16_kernel", "thin_grad_bf16_kernel")


def read(r):
    if r.trace is None:
        return None
    busy = sum(e - s for _, s, e in r.trace.wrapper_kernels(KERNELS))
    if busy <= 0:
        return None
    t, m = r.cell.traffic, r.cell.model
    least = 0.0
    for info in r.trace.results:
        evals = max(info["nfe_bwd"][1] - 2, 0)
        least += evals * peaks.roofline_s(*flops.cnf_work(m, info["seqs"] * t["seq_len"],
                                                          t["points"], 4))
    return 100.0 * least / busy
