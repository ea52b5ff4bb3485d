"""The algorithm's work, counted from shapes and the measured NFE, whatever
implements it: products (2 flops a multiply-add) of the dense layers, and
bytes each input read once and each output written once.

Where the model admits a cheaper exact form, the cheaper one is counted
(a SA scale's first conv over the source points before the gather, the
feature-propagation conv's source block before the interpolation, the
fusion conv's global block once a sequence), so that no implementation of
the same function does less than is counted and no share passes 100%.
Elementwise work (softplus, GroupNorm, gates) is not counted.
"""

from __future__ import annotations

from reference.caspr import sa_levels

F32 = 4


def mlp(dims):
    """Multiply-adds of one row through a chain of widths."""
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def cnf_layers(m):
    """The per-point layer widths of the CNF's ODEnet."""
    return [3] + list(m["cnf_dims"]) + [3]


def cnf_context(m):
    """Multiply-adds of one cloud's gates and hyper biases at one evaluation."""
    return sum(2 * (1 + m["latent_feat_size"]) * d for d in cnf_layers(m)[1:])


def cnf_work(m, clouds, points, passes):
    """(flops, bytes) of one evaluation of the ODEnet's per-point layers over
    clouds x points rows: ``passes`` = 1 the field, 2 the field and its
    tangent, 4 the backward of both (input and weight gradients)."""
    rows = clouds * points
    dims = cnf_layers(m)
    flops = 2.0 * passes * rows * mlp(dims)
    weights = sum(a * b for a, b in zip(dims[:-1], dims[1:])) * F32
    gates = clouds * 2 * (len(dims) - 1) * max(dims) * F32
    streams = {1: 2, 2: 4, 4: 7}[passes]  # (B*N, 3) arrays read and written
    return flops, rows * 3 * F32 * streams + weights + gates


def encoder_flops(m, frames, points):
    """Products of one sequence's encode (T-NOCS head included)."""
    tn = frames * points
    lf, gf, sf, out = (m["local_feat_size"], m["global_feat_size"], m["space_time_pt_feat"],
                       m["latent_feat_size"])
    flops = 2 * tn * mlp([4, sf, 128, gf])
    n, cin, sizes, sa_out = points, 6 + 3, [points], []
    for m_out, scales in sa_levels(m):
        m_out = min(m_out, n)
        for _, k, w in scales:
            flops += 2 * frames * (n * cin * w[0] + m_out * k * mlp(list(w)))
        sa_out.append(sum(w[-1] for _, _, w in scales))
        cin, n = sa_out[-1] + 3, m_out
        sizes.append(m_out)
    fp_w = [lf, lf, max(lf // 2, lf), max(lf // 2, lf), max(lf // 4, lf)]
    skips = [sa_out[3], sa_out[2], sa_out[1], sa_out[0], 6]
    src = sa_out[4]
    for i in range(5):
        fine, coarse = sizes[4 - i], sizes[5 - i]
        flops += 2 * frames * (coarse * src * fp_w[i] + fine * skips[i] * fp_w[i]
                               + fine * fp_w[i] * fp_w[i])
        src = fp_w[i]
    flops += 2 * tn * (src * src + src * lf)
    flops += 2 * tn * ((lf + sf) * (gf + sf + lf) + (gf + sf + lf) * out + out * 4)
    flops += 2 * gf * (gf + sf + lf)
    return float(flops)


def latent_flops(m):
    """Products of one row through the latent ODE's field."""
    h, z = m["ode_hidden_size"], m["motion_feat_size"]
    return 2.0 * mlp([z, h, h, h, z])


def reconstruct_flops(m, frames, points, nfe_ode, nfe_cnf):
    """Products of one sequence's reconstruct, decoded at its frames."""
    cnf = cnf_work(m, frames, points, 1)[0] + 2.0 * frames * cnf_context(m)
    return encoder_flops(m, frames, points) + nfe_ode * latent_flops(m) + nfe_cnf * cnf


def train_flops(m, frames, points, nfe_fwd, nfe_bwd):
    """Products of one sequence's training step: the encoder forward and
    backward (3x the forward); the latent ODE's forward evaluations and its
    adjoint's (each the field and its VJP, 3x); the CNF's forward evaluations
    (the field and its tangent) and its adjoint's (the same, and their
    backward but at the two plain evaluations of its one interval's ends),
    with the context products likewise."""
    ode_f, ode_b = nfe_fwd[0], nfe_bwd[0]
    cnf_f, cnf_b = nfe_fwd[1], nfe_bwd[1]
    ctx = 2.0 * frames * cnf_context(m)
    fwd = cnf_work(m, frames, points, 2)[0]
    bwd = cnf_work(m, frames, points, 4)[0]
    return (3 * encoder_flops(m, frames, points) + (ode_f + 3 * ode_b) * latent_flops(m)
            + (cnf_f + cnf_b) * (fwd + ctx) + max(cnf_b - 2, 0) * (bwd + 2 * ctx))
