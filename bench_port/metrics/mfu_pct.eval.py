"""The whole call's share of the card's peak: the model's products for the
window's sequences at their measured NFE (harness/flops.py) over the
window's time, against the dense bf16 rate (harness/peaks.py)."""

from harness import flops, peaks


def read(r):
    m, t = r.cell.model, r.cell.traffic
    work = 0.0
    for info in r.infos:
        if "nfe" in info:
            work += info["seqs"] * flops.reconstruct_flops(m, t["frames"], t["points"], *info["nfe"])
        else:
            work += info["seqs"] * flops.encoder_flops(m, t["frames"], t["points"])
    return 100.0 * work / r.window_s / peaks.DENSE_FLOPS
