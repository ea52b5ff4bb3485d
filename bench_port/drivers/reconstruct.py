"""Entry: ``CaSPRModel.reconstruct`` of caspr_tpu_torch, the shape
reconstruction protocol: encode a batch of observed sequences, advect the
latent to each observed time, decode the traffic's points there from base
samples that the benchmark draws (handed to program and reference alike).

One call is one batch of the pool, synchronised.  The check recomputes the
sampled calls with the plain reference and compares the T-NOCS prediction
and the decoded points by their widest gap, and the NFE pair.
"""

from __future__ import annotations

import torch

from harness import core, program, sequences
from reference import caspr as ref


class Driver:
    entry, output_index = "reconstruct", 2  # the decoded points
    spans = {"encode_ms": "encode", "latent_ms": "aggregate_and_solve_latent",
             "decode_ms": "decode_from_samples"}

    def __init__(self, cell, device, pool_seed, weight_seed):
        self.cell, self.device, self.traffic = cell, device, cell.traffic
        program.precision(cell)
        self.model = program.model(cell, device)
        self.weight_seed = weight_seed
        self.params, self.state = program.weights(cell, self.model.cfg, device, weight_seed)
        self.pool = sequences.make_pool(program.generator(device, pool_seed), self.traffic, device)

    def warm(self):
        for i in range(self.traffic["warmup_calls"]):
            self.call(i)

    def call(self, i):
        entry = self.pool[i % len(self.pool)]
        with torch.no_grad():
            _, _, points, tnocs, nfe = self.model.reconstruct(
                self.params, self.state, entry["input"], None,
                num_points=self.traffic["points"], base_samples=entry["base"],
                max_timestamp=self.traffic["max_timestamp"])
        if self.device == "cuda":
            torch.cuda.synchronize()
        return {"seqs": entry["input"].shape[0], "entry": i % len(self.pool),
                "nfe": tuple(float(v) for v in nfe), "outputs": (tnocs, points)}

    def release(self):
        """Free the program's state and take the reference's weights."""
        self.model = self.params = self.state = None
        self.ref_params, self.ref_state = program.reference_weights(self.cell, self.device,
                                                                    self.weight_seed)

    def reference(self, entry_index, tf32=False):
        """(outputs, nfe) of the plain reference on one pool entry."""
        program.precision(self.cell, tf32)
        entry = self.pool[entry_index]
        with torch.no_grad():
            tnocs, points, nfe = ref.reconstruct(self.ref_params, self.ref_state, self.cell.model,
                                                 entry["input"], entry["base"],
                                                 self.traffic["max_timestamp"])
        program.precision(self.cell)
        return (tnocs, points), nfe

    @staticmethod
    def compare(outputs, nfe, ref_outputs, ref_nfe):
        return {"tnocs_gap": float((outputs[0] - ref_outputs[0]).abs().max()),
                "points_gap": float((outputs[1] - ref_outputs[1]).abs().max()),
                "nfe_gap": max(abs(a - b) for a, b in zip(nfe, ref_nfe))}

    def check(self, sample):
        return core.sample_checks(self, sample, self.traffic["limits"])
