"""The program under test, caspr_tpu_torch, as a configuration file states it,
and the weights each side is handed.  The parameter tree's layout and the
checkpoint's reader are those of the cell's reference (``cell.reference``)."""

from __future__ import annotations

import torch

from .weights import seeded_weights


def model(cell, device):
    """caspr_tpu_torch's CaSPRModel for the configuration, after checking that
    the program's solver and normalisation constants are the file's."""
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel

    cfg = CaSPRConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in cell.config["model"].items()})
    solver = cell.config["solver"]
    cnf, ode = cfg.cnf_config(), cfg.latent_ode_config()
    held = {"cnf_rtol": cnf.rtol, "cnf_atol": cnf.atol, "cnf_time_length": cnf.time_length,
            "cnf_bn_eps": cnf.bn_eps, "cnf_bn_decay": cnf.bn_decay,
            "latent_ode_rtol": ode.rtol, "latent_ode_atol": ode.atol}
    wrong = {k: (v, solver[k]) for k, v in held.items() if v != solver[k]}
    if wrong:
        raise ValueError(f"the program departs from the configuration (program, file): {wrong}")
    return CaSPRModel(cfg, device)


def made_weights(cell, device, seed):
    """(params, state) made from the seed by the benchmark (``weights:
    "seed"``): linear layers by ``seeded_weights``; MovingBatchNorm weights
    and biases 0 with running mean 0 and variance 1; sqrt_end_time
    sqrt(time_length), as the model initialises them."""
    m = cell.model
    params = seeded_weights(generator(device, seed), cell.reference.param_shapes(m), device)
    state = {}
    if "point_cnf" in params:
        chain = params["point_cnf"]
        for norm in (chain[0], chain[2]):
            norm["weight"].zero_()
        chain[1]["sqrt_end_time"] = torch.tensor(m["cnf_time_length"] ** 0.5, device=device)
        fresh = lambda: {"running_mean": torch.zeros(3, device=device),
                         "running_var": torch.ones(3, device=device),
                         "step": torch.zeros(1, device=device)}
        state["point_cnf"] = [fresh(), {}, fresh()]
    return params, state


def stated_dtype(cell, params):
    """``params`` after checking that every weight is in the dtype that the
    configuration's ``precision`` states."""
    want = getattr(torch, cell.config["precision"]["dtype"])
    found = {str(leaf.dtype) for leaf in leaves(params) if leaf.dtype != want}
    if found:
        raise ValueError(f"weights in {sorted(found)}, the configuration states {want}")
    return params


def weights(cell, cfg, device, seed):
    """The program's (params, state): the configuration's checkpoint through
    the program's own loader, or the benchmark's weights from the seed."""
    if cell.config["weights"] == "seed":
        params, state = made_weights(cell, device, seed)
    else:
        from caspr_tpu_torch.weights import load_demo

        params, state = load_demo(cfg, device, path=str(cell.root / cell.config["weights"]))
    return stated_dtype(cell, params), state


def reference_weights(cell, device, seed):
    """A fresh (params, state) for the reference: the checkpoint through the
    reference's own loader, or the same weights made again from the seed."""
    if cell.config["weights"] == "seed":
        params, state = made_weights(cell, device, seed)
    else:
        params, state = cell.reference.load_checkpoint(str(cell.root / cell.config["weights"]),
                                                       device)
    return stated_dtype(cell, params), state


def leaves(tree):
    """The tensors of a tree of dicts and lists, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for v in items for leaf in leaves(v)]


def generator(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def precision(cell, tf32: bool | None = None):
    """Set float32 products as the configuration states (TF32 off), or with
    ``tf32`` as asked: the reference's control runs with TF32 on."""
    on = cell.config["precision"]["tf32"] if tf32 is None else tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
