"""How far two correct bf16 VJPs of the CNF lie apart (card).

The bf16 VJP (``ops.kernels.cnf_dynamics_vjp(..., "bf16")``, its plain
version ``ops.cnf_fused.dynamics_vjp_packed(..., "bf16")``) rounds both
operands of every product to bfloat16.  Two implementations that round the
same values agree to the last bit only where their float32 sums agree: a
sum in another order that lands on the other side of a bfloat16 rounding
boundary moves that operand by one unit (2^-8 relative), and the layers
after it carry the change on.  This prints, for each case, the kernel's
distance from its plain version on the card, the plain version's on the
card from the same function on the CPU (nothing but the sums' order differs
between those two), and each one's distance from the float64 VJP without
rounding, every distance over the reference's largest magnitude, for two
input recipes: ``model_like`` (the ODEnet drawn as caspr_init draws it, its
gates and biases from ``context_gb``; tests/test_torch_port_kernels.py's
bf16 VJP case) and ``uniform_gates`` (gates and biases uniform in [0, 1),
w_first standard normal: the float32 kernel tests' recipe).

    python3 -m caspr_tpu_torch.checks.vjp_bf16_agreement
"""

from __future__ import annotations

import json
import sys

import torch

from ..ops import cnf_fused, kernels

ZDIM = 16
CASES = [(h, hidden, n) for h in (128, 512) for hidden in (1, 2, 6) for n in (45, 256, 1024)]


def _noise(shape, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def model_like_vjp_inputs(h, num_hidden, n, seed, bt=3):
    """cnf_dynamics_vjp's arguments (CPU tensors) as the model gives them: an
    ODEnet of num_hidden + 2 concatsquash layers drawn as caspr_init draws
    it (every weight and bias uniform within 1/sqrt(fan in)), its gates and
    effective biases from ``context_gb`` at a standard normal context, and
    standard normal points, noise and cotangents."""
    g = torch.Generator().manual_seed(seed)
    u = lambda fan, *shape: (2.0 * torch.rand(shape, generator=g) - 1.0) / fan ** 0.5
    widths = [3] + [h] * (num_hidden + 1) + [3]
    layers = [{"_layer": {"weight": u(d_in, d_out, d_in), "bias": u(d_in, d_out)},
               "_hyper_bias": {"weight": u(1 + ZDIM, d_out, 1 + ZDIM)},
               "_hyper_gate": {"weight": u(1 + ZDIM, d_out, 1 + ZDIM), "bias": u(1 + ZDIM, d_out)}}
              for d_in, d_out in zip(widths[:-1], widths[1:])]
    odenet = {"layers": layers}
    gb = cnf_fused.context_gb(odenet, torch.randn((bt, 1 + ZDIM), generator=g))
    y = torch.randn((bt, n, 3), generator=g)
    return [y, _noise(y.shape, seed + 1), gb, *cnf_fused.pack_weights(odenet),
            _noise(y.shape, seed + 2), _noise(y.shape[:2], seed + 3)]


def uniform_gates_vjp_inputs(h, num_hidden, n, seed, bt=3):
    """The same arguments with gates and effective biases uniform in [0, 1),
    w_first standard normal and the other weights normal over sqrt(H)."""
    g = torch.Generator().manual_seed(seed)
    y = torch.randn((bt, n, 3), generator=g)
    gb = torch.rand((bt, max(8, 2 * (num_hidden + 2)), h), generator=g)
    wf = torch.randn((h, 3), generator=g)
    wh = torch.randn((num_hidden, h, h), generator=g) / h ** 0.5
    wl = torch.randn((3, h), generator=g) / h ** 0.5
    return [y, _noise(y.shape, seed + 1), gb, wf, wh, wl, _noise(y.shape, seed + 2),
            _noise(y.shape[:2], seed + 3)]


def _rel(got, want):
    return float((got.double().cpu() - want.double().cpu()).abs().max()
                 / want.double().cpu().abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("vjp_bf16_agreement: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    names = ("dy", "dgb", "dw_first", "dw_hidden", "dw_last")
    recipes = {"model_like": model_like_vjp_inputs, "uniform_gates": uniform_gates_vjp_inputs}
    for recipe, make in recipes.items():
        for h, hidden, n in CASES:
            cpu = make(h, hidden, n, seed=h + hidden)
            card = [t.cuda() for t in cpu]
            got = kernels.cnf_dynamics_vjp(*card, "bf16")
            plain = cnf_fused.dynamics_vjp_packed(*card, "bf16")
            plain_cpu = cnf_fused.dynamics_vjp_packed(*cpu, "bf16")
            exact = cnf_fused.dynamics_vjp_packed(*(t.double() for t in card))
            row = {k: {"kernel_vs_plain": _rel(k_, p), "plain_card_vs_cpu": _rel(p, c),
                       "kernel_vs_float64": _rel(k_, x), "plain_vs_float64": _rel(p, x)}
                   for k, k_, p, c, x in zip(names, got, plain, plain_cpu, exact)}
            worst = lambda key: max(v[key] for v in row.values())
            print(json.dumps({"recipe": recipe, "h": h, "hidden_layers": hidden, "points": n,
                              "worst_kernel_vs_plain": worst("kernel_vs_plain"),
                              "worst_plain_card_vs_cpu": worst("plain_card_vs_cpu"),
                              "worst_float64_ratio": max(v["kernel_vs_float64"]
                                                         / v["plain_vs_float64"]
                                                         for v in row.values()),
                              "outputs": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
