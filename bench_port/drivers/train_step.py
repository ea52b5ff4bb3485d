"""Entry: the train step of caspr_tpu_torch (``train/loop.py::
make_train_step``): the likelihood forward through encoder, latent ODE and
CNF, the weighted CNF and T-NOCS losses, their gradient by the continuous
adjoint, one Adam update of the parameters in place.

Set-up builds the one step object with its model and optimizer state and
drives it through the traffic's first ``check_steps`` steps on distinct
batches of the pool, through the same call the window makes; the window
then goes on with that object.  The check has the plain reference follow
those first steps from the same weights and inputs (the Hutchinson noise
included) and compares each step's loss, each leaf's first gradient as the
optimizer got it (from Adam's first moment after one step) and each leaf's
change over the steps, by the gap of their norms against the reference's
norm of that leaf or of its group's median leaf, whichever is larger.  The
groups are the model's parts, the parameter tree's top-level keys (encoder,
latent ODE, CNF): each group's median leaf is compared on its own, so that
a fault in the CNF's few leaves is not outvoted by the encoder's many.
"""

from __future__ import annotations

import statistics

import torch

from harness import program, sequences
from reference import caspr as ref


def group_of(leaf_name):
    """A leaf's group: its tree's top-level key (``encoder``, ``latent_ode``,
    ``point_cnf``)."""
    return leaf_name.split("/")[1]


def named_leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(named_leaves(v, f"{prefix}/{k}"))
    return out


class Driver:
    entry = "train_step"
    spans = {}

    def __init__(self, cell, device, pool_seed, weight_seed):
        from caspr_tpu_torch.train.loop import make_optimizer, make_train_step

        self.cell, self.device, self.traffic = cell, device, cell.traffic
        program.precision(cell)
        self.model = program.model(cell, device)
        self.weight_seed = weight_seed
        self.params, self.state = program.weights(cell, self.model.cfg, device, weight_seed)
        recipe = cell.config["train"]
        tx = make_optimizer(recipe["lr"], tuple(recipe["betas"]), recipe["eps"])
        self.opt = tx.init(self.params)
        self.step = make_train_step(self.model, tx, recipe["cnf_loss_weight"],
                                    recipe["tnocs_loss_weight"])
        self.pool = sequences.make_pool(program.generator(device, pool_seed), self.traffic, device)

    def warm(self):
        """The first steps, recorded for the check."""
        beta1 = self.cell.config["train"]["betas"][0]
        leaves = named_leaves(self.params)
        start = {k: v.detach().clone() for k, v in leaves.items()}
        self.first = []
        for k in range(self.traffic["check_steps"]):
            self.first.append(self._step(k))
            if k == 0:
                # the gradient as the optimizer got it: its first moment after
                # one step is (1 - beta1) g (none where it took no step)
                moments = {n: self.opt.state.get(p, {}).get("exp_avg") for n, p in leaves.items()}
                self.grads = {n: 0.0 if v is None else (v / (1.0 - beta1)).norm().item()
                              for n, v in moments.items()}
        self.change = {n: (p.detach() - start[n]).norm().item() for n, p in leaves.items()}
        del start

    def _step(self, k):
        entry = self.pool[k % len(self.pool)]
        self.params, self.opt, self.state, m = self.step(
            self.params, self.opt, self.state, entry["input"], entry["target"], None,
            e=entry["noise"])
        if self.device == "cuda":
            torch.cuda.synchronize()
        return {"seqs": entry["input"].shape[0], "loss": m["loss"], "nfe": m["nfe_forward"],
                "nfe_bwd": tuple(a - b for a, b in zip(m["nfe"], m["nfe_forward"]))}

    def call(self, i):
        return self._step(self.traffic["check_steps"] + i)

    def release(self):
        self.model = self.params = self.state = self.opt = self.step = None

    def reference(self, tf32=False):
        """The plain reference's first steps: (losses, nfe pairs, first
        gradient norms, change norms), each norm by leaf name."""
        program.precision(self.cell, tf32)
        recipe = self.cell.config["train"]
        params, state = program.reference_weights(self.cell, self.device, self.weight_seed)
        leaves = named_leaves(params)
        start = {k: v.clone() for k, v in leaves.items()}
        opt = torch.optim.Adam(list(leaves.values()), lr=recipe["lr"],
                               betas=tuple(recipe["betas"]), eps=recipe["eps"])
        steps, grads = [], {}
        for k in range(self.traffic["check_steps"]):
            entry = self.pool[k % len(self.pool)]
            state, m = ref.train_step(params, opt, state, self.cell.model, entry["input"],
                                      entry["target"], entry["noise"],
                                      recipe["cnf_loss_weight"], recipe["tnocs_loss_weight"])
            steps.append({"loss": m["loss"], "nfe": m["nfe_forward"], "nfe_bwd": m["nfe_backward"]})
            if k == 0:
                grads = {n: (opt.state[p]["exp_avg"] / (1.0 - recipe["betas"][0])).norm().item()
                         for n, p in leaves.items()}
        change = {n: (p.detach() - start[n]).norm().item() for n, p in leaves.items()}
        program.precision(self.cell)
        return steps, grads, change

    @staticmethod
    def leaf_gaps(steps, grads, change, ref_steps, ref_grads, ref_change):
        """Per kept leaf, the gaps of the first gradient's and of the
        change's norms against the reference's norm of that leaf or of its
        group's median leaf, whichever is larger; and each step's loss gap."""
        groups = {}
        for n, g in ref_grads.items():
            groups.setdefault(group_of(n), {})[n] = g
        # leaves whose gradient is nought to rounding move under Adam by
        # round-off alone (a conv bias before a GroupNorm of one channel a
        # group): left out by this rule on the reference's gradient
        kept = {}
        for name, members in groups.items():
            median = statistics.median(members.values())
            kept[name] = [n for n, g in members.items() if g >= 1e-3 * median]

        def gaps(prog, reference):
            out = {}
            for names in kept.values():
                floor = statistics.median(reference[n] for n in names)
                out.update({n: abs(prog[n] - reference[n]) / max(reference[n], floor)
                            for n in names})
            return out

        losses = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(steps, ref_steps)]
        return gaps(grads, ref_grads), gaps(change, ref_change), losses

    def compare(self, steps, grads, change, ref_steps, ref_grads, ref_change):
        """The compared numbers: the widest loss gap of the steps; for each
        group (``grad_gap.<group>``, ``change_gap.<group>``) its median
        leaf's gaps of the first gradient and of the change (a single leaf
        swings with max-pool choices, see PERF.md); the widest NFE gap."""
        grad, moved, losses = self.leaf_gaps(steps, grads, change, ref_steps, ref_grads,
                                             ref_change)
        nfe = max(abs(x - y) for a, b in zip(steps, ref_steps)
                  for x, y in zip(a["nfe"] + a["nfe_bwd"], b["nfe"] + b["nfe_bwd"]))
        numbers = {"loss_gap": max(losses), "nfe_gap": nfe}
        for kind, gaps in (("grad_gap", grad), ("change_gap", moved)):
            for name in sorted({group_of(n) for n in gaps}):
                numbers[f"{kind}.{name}"] = statistics.median(
                    g for n, g in gaps.items() if group_of(n) == name)
        return numbers

    def check(self, sample):
        numbers = self.compare(self.first, self.grads, self.change, *self.reference())
        limits = self.traffic["limits"]
        return [(k, numbers[k], limits[k]) for k in limits]
