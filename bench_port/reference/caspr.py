"""CaSPR in plain PyTorch, float32: the benchmark's reference.

TPointNet++ encoder -> latent ODE -> conditional CNF decoder (Rempe et al.,
"CaSPR: Learning Canonical Spatiotemporal Point Cloud Representations",
NeurIPS 2020; github.com/davrempe/caspr), in the parameter layout of the
JAX checkpoints (weights (out, in), as torch.nn.Linear), written for the
configuration files of ``bench_port/configs``: concatsquash layers with
softplus, one CNF block between two MovingBatchNorms.

It imports nothing of the program and computes every stage in its plain,
unfactored form: a farthest point sampling per SA level, every ball query
on its own, grouped neighbourhoods through the whole mini-PointNet, the
interpolated features concatenated before the feature-propagation conv,
the fusion conv over the concatenated per-point features, GroupNorm over
(positions, channels of a group) at once, and the CNF layers as
``(z W^T + b) * sigmoid(tc Wg^T + bg) + tc Wb^T``.  The index semantics of
the point operations are the published CUDA ops' (first index on ties,
first hits of a ball in index order, padded with the first), with squared
distances summed as (dx*dx + dy*dy) + dz*dz.

The encoder runs a few sequences at a time (``chunk``), which changes no
value: every statistic and maximum in it is per sequence.
"""

from __future__ import annotations

import math
import pickle

import numpy as np
import torch

from .dopri5 import F32, odeint, odeint_adjoint

GROUPS = 16


# ---------------------------------------------------------------- weights

class _Unpickler(pickle.Unpickler):
    """Admits numpy arrays and stands in for optax's two state classes."""

    def find_class(self, module, name):
        if module.split(".")[0] == "optax" and name in ("ScaleByAdamState", "EmptyState"):
            return lambda *a, **k: None
        if module.split(".")[0] == "numpy" and name in (
                "dtype", "ndarray", "_reconstruct", "_frombuffer", "scalar"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"{module}.{name} is not admitted")


def load_checkpoint(path: str, device):
    """(params, state) of a JAX-layout checkpoint pickle as float32 tensors."""
    with open(path, "rb") as f:
        ck = _Unpickler(f).load()

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [conv(v) for v in tree]
        return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)

    return conv(ck["params"]), conv(ck["state"])


# model keys whose value the reference fixes: it computes this model alone
IMPLEMENTS = {"cnf_layer_type": "concatsquash", "cnf_nonlinearity": "softplus", "cnf_blocks": 1,
              "augment_quad": True, "augment_pairs": True, "regress_tnocs": True,
              "tnocs_point_size": 4}


def check_model(m):
    """Refuse a model section that asks for another model than the one the
    reference computes."""
    wrong = {k: m.get(k) for k, v in IMPLEMENTS.items() if m.get(k) != v}
    if wrong:
        raise ValueError(f"the reference computes {IMPLEMENTS}, not {wrong}")


def sa_levels(m):
    """[(points out, [(radius, K, mlp widths)] x 2)] of the five SA levels."""
    r, p, (k1, k2) = m["radii_list"], m["sa_points"], m["ball_samples"]
    mlps = [((16, 16, 32), (32, 32, 64)), ((32, 32, 64), (32, 32, 64)),
            ((64, 64, 128), (64, 96, 128)), ((128, 256, 256), (128, 256, 256)),
            ((256, 256, 512), (256, 256, 512))]
    return [(p[i], [(r[i], k1, mlps[i][0]), (r[i + 1], k2, mlps[i][1])]) for i in range(5)]


def _stack(in_ch, widths):
    dims = [in_ch] + list(widths)
    return {"convs": [{"weight": (dims[i + 1], dims[i]), "bias": (dims[i + 1],)}
                      for i in range(len(widths))],
            "norms": [{"weight": (d,), "bias": (d,)} for d in widths]}


def param_shapes(m):
    """The parameter tree's shapes for a model section of a config file."""
    in_feat = 6
    lf, out, gf, sf = (m["local_feat_size"], m["latent_feat_size"], m["global_feat_size"],
                       m["space_time_pt_feat"])
    sas, in_ch, sa_out = [], in_feat + 3, []
    for _, scales in sa_levels(m):
        sas.append({"scales": [_stack(in_ch, w) for _, _, w in scales]})
        sa_out.append(sum(w[-1] for _, _, w in scales))
        in_ch = sa_out[-1] + 3
    fp_w = [lf, lf, max(lf // 2, lf), max(lf // 2, lf), max(lf // 4, lf)]
    skips = [sa_out[3], sa_out[2], sa_out[1], sa_out[0], in_feat]
    prev, fps = sa_out[4], []
    for i in range(5):
        fps.append(_stack(skips[i] + prev, [fp_w[i]] * 2))
        prev = fp_w[i]
    lin = lambda o, i: {"weight": (o, i), "bias": (o,)}
    norm = lambda c: {"weight": (c,), "bias": (c,)}
    d = gf + sf + lf
    enc = {
        "local_extract": {"set_abstractions": sas, "feature_propagators": fps,
                          "final_conv1": lin(prev, prev), "final_norm": norm(prev),
                          "final_conv2": lin(lf, prev)},
        "global_extract": {"conv1": lin(sf, 4), "conv2": lin(128, sf), "conv3": lin(gf, 128),
                           "bn1": norm(sf), "bn2": norm(128), "bn3": norm(gf)},
        "conv1": lin(d, d), "conv2": lin(out, d), "bn1": norm(d), "bn2": norm(out),
        "conv3": lin(4, out),
    }
    params = {"encoder": enc}
    if m["pretrain_tnocs"]:
        return params
    h, z = m["ode_hidden_size"], m["motion_feat_size"]
    params["latent_ode"] = {f"layer{i}": lin(o, i_) for i, (i_, o) in
                            enumerate([(z, h), (h, h), (h, h), (h, z)])}
    layers, d_in = [], 3
    for d_out in list(m["cnf_dims"]) + [3]:
        layers.append({"_layer": lin(d_out, d_in), "_hyper_bias": {"weight": (d_out, 1 + out)},
                       "_hyper_gate": lin(d_out, 1 + out)})
        d_in = d_out
    params["point_cnf"] = [{"weight": (3,), "bias": (3,)},
                           {"odenet": {"layers": layers}, "sqrt_end_time": ()},
                           {"weight": (3,), "bias": (3,)}]
    return params


# ------------------------------------------------------------- point ops

def sqdist(a, b):
    """a (..., M, 3), b (..., N, 3) -> (..., M, N) as (dx*dx + dy*dy) + dz*dz."""
    d = a[..., :, None, :] - b[..., None, :, :]
    dx, dy, dz = d.unbind(-1)
    return dx * dx + dy * dy + dz * dz


def fps(xyz, m):
    """Farthest point sampling from index 0; the first maximum wins a tie."""
    b, n, _ = xyz.shape
    if m >= n:
        idx = torch.arange(n, device=xyz.device)
        return torch.cat([idx, idx.new_zeros(m - n)]).expand(b, m)
    rows = torch.arange(b, device=xyz.device)
    out = torch.zeros((b, m), dtype=torch.long, device=xyz.device)
    best = torch.full((b, n), float("inf"), device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    for i in range(1, m):
        d = xyz - xyz[rows, last][:, None, :]
        dx, dy, dz = d.unbind(-1)
        best = torch.minimum(best, dx * dx + dy * dy + dz * dz)
        last = torch.argmax(best, dim=1)
        out[:, i] = last
    return out


def gather(points, idx):
    """points (B, N, C), idx (B, ...) -> (B, ..., C)."""
    b, n, c = points.shape
    flat = idx.reshape(b, -1)
    return torch.gather(points, 1, flat[:, :, None].expand(-1, -1, c)).reshape(*idx.shape, c)


def ball_query(xyz, centres, radius, k):
    """The first k sources (index order) within radius of each centre,
    padded with the first hit, 0 for an empty ball: (B, M, k)."""
    n = xyz.shape[1]
    inside = sqdist(centres, xyz) < float(np.float32(radius * radius))
    order = torch.arange(n, device=xyz.device).expand_as(inside)
    key = torch.where(inside, order, torch.full_like(order, n))
    first = torch.sort(key, dim=-1).values[..., :k]
    if first.shape[-1] < k:
        first = torch.cat([first, first.new_full((*first.shape[:-1], k - first.shape[-1]), n)], -1)
    hit = first < n
    return torch.where(hit, first, torch.where(hit[..., :1], first[..., :1], 0))


def three_nn(query, source):
    """The three nearest sources of each query (squared distance, index),
    the lower index first on a tie."""
    d2, idx = torch.sort(sqdist(query, source), dim=-1, stable=True)
    return d2[..., :3], idx[..., :3]


# ---------------------------------------------------------------- layers

def linear(p, x):
    y = x @ p["weight"].T
    return y + p["bias"] if "bias" in p else y


def group_norm(p, x, eps=1e-5):
    """GroupNorm(16) of channels-last x (B, ..., C): biased statistics per
    sample and group over every position and the group's channels."""
    b, c = x.shape[0], x.shape[-1]
    g = x.reshape(b, -1, GROUPS, c // GROUPS)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = ((g - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    return ((g - mean) / torch.sqrt(var + eps)).reshape(x.shape) * p["weight"] + p["bias"]


def conv_stack(p, h, relu_last=True):
    n = len(p["convs"])
    for i, (conv, norm) in enumerate(zip(p["convs"], p["norms"])):
        h = group_norm(norm, linear(conv, h))
        if i < n - 1 or relu_last:
            h = torch.relu(h)
    return h


# a list while a look records which entry of each ball wins its max-pool
# (readings.py): (label, argmax) per pool, in order
TAPE = None


def pointnet2(p, m, points):
    """points (B, N, 9) -> per-point features (B, N, local_feat_size)."""
    xyz, feat = points[..., :3], points[..., 3:]
    xyzs, feats = [xyz], [feat]
    for level, ((m_out, scales), lp) in enumerate(zip(sa_levels(m), p["set_abstractions"])):
        centres = gather(xyz, fps(xyz, m_out))
        outs = []
        for scale, ((radius, k, _), sp) in enumerate(zip(scales, lp["scales"])):
            idx = ball_query(xyz, centres, radius, k)
            grouped = torch.cat([gather(xyz, idx) - centres[:, :, None, :], gather(feat, idx)], -1)
            b, mm, kk, c = grouped.shape
            # the mini-PointNet's GroupNorm takes its statistics per ball
            h = conv_stack(sp, grouped.reshape(b * mm, kk, c), relu_last=False)
            if TAPE is not None:
                TAPE.append((f"sa{level}.{scale}", h.detach().argmax(dim=1).to(torch.int8)))
            outs.append(h.amax(dim=1).reshape(b, mm, -1))
        xyz, feat = centres, torch.cat(outs, dim=-1)
        xyzs.append(xyz)
        feats.append(feat)
    for level, fp in zip(range(len(xyzs) - 2, -1, -1), p["feature_propagators"]):
        d2, idx = three_nn(xyzs[level], xyzs[level + 1])
        w = 1.0 / (d2 + 1e-8)
        w = w / w.sum(dim=-1, keepdim=True)
        interp = (gather(feats[level + 1], idx) * w[..., None]).sum(dim=2)
        feats[level] = conv_stack(fp, torch.cat([interp, feats[level]], dim=-1))
    h = torch.relu(group_norm(p["final_norm"], linear(p["final_conv1"], feats[0])))
    return linear(p["final_conv2"], h)


def encode_chunk(p, m, x):
    """x (B, T, N, 4) -> (z0 (B, latent), tnocs (B, T, N, 4))."""
    b, t, n, _ = x.shape
    s = x.reshape(b * t, n, 4)[..., :3]
    sx, sy, sz = s[..., 0:1], s[..., 1:2], s[..., 2:3]
    local = pointnet2(p["local_extract"], m,
                      torch.cat([s, s * s, sx * sz, sx * sy, sz * sy], dim=-1))
    g = p["global_extract"]
    pf = torch.relu(group_norm(g["bn1"], linear(g["conv1"], x.reshape(b, t * n, 4))))
    h = torch.relu(group_norm(g["bn2"], linear(g["conv2"], pf)))
    gvec = group_norm(g["bn3"], linear(g["conv3"], h)).amax(dim=1)
    fused = torch.cat([local.reshape(b, t * n, -1),
                       gvec[:, None, :].expand(b, t * n, gvec.shape[-1]), pf], dim=-1)
    h = torch.relu(group_norm(p["bn1"], linear(p["conv1"], fused)))
    feat = group_norm(p["bn2"], linear(p["conv2"], h))
    tnocs = torch.sigmoid(linear(p["conv3"], torch.relu(feat)))
    return feat.amax(dim=1), tnocs.reshape(b, t, n, 4)


def encode(params, m, x, chunk=4):
    parts = [encode_chunk(params["encoder"], m, x[i:i + chunk]) for i in range(0, len(x), chunk)]
    return torch.cat([a for a, _ in parts]), torch.cat([b for _, b in parts])


# ------------------------------------------------------------ latent ODE

def latent_field(p, z):
    for i in range(4):
        z = linear(p[f"layer{i}"], z)
        if i < 3:
            z = torch.tanh(z)
    return z


def solve_latent(params, m, z0, times, *, train=False, nfe_bwd=None):
    """z0 (B, latent), times (B, T) -> (features (B, T, latent), nfe): the
    motion part advected to the sorted flattened times of every row and
    taken back at each row's own, the static part repeated."""
    b, t = times.shape
    dyn, stat = z0[:, :m["motion_feat_size"]], z0[:, m["motion_feat_size"]:]
    flat = times.reshape(-1)
    order = torch.argsort(flat, stable=True)
    rel = flat[order] - flat[order][0]
    rank = torch.argsort(order, stable=True).reshape(b, t)
    tol = dict(rtol=m["latent_ode_rtol"], atol=m["latent_ode_atol"])
    if train:
        (zs,), nfe = odeint_adjoint(lambda _t, y, p: (latent_field(p, y[0]),), (dyn,), rel,
                                    params["latent_ode"], nfe_bwd=nfe_bwd, **tol)
    else:
        (zs,), nfe = odeint(lambda _t, y: (latent_field(params["latent_ode"], y[0]),), (dyn,),
                            rel, **tol)
    feats = torch.take_along_dim(zs.permute(1, 0, 2), rank[..., None], dim=1)
    return torch.cat([feats, stat[:, None, :].expand(b, t, stat.shape[-1])], dim=-1), nfe


# ------------------------------------------------------------------- CNF

def softplus(x):
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _gates(layers, t, context):
    tc = torch.cat([torch.full((context.shape[0], 1), float(t), device=context.device),
                    context], dim=1)
    return [(torch.sigmoid(linear(lp["_hyper_gate"], tc))[:, None, :],
             (tc @ lp["_hyper_bias"]["weight"].T)[:, None, :]) for lp in layers]


def field(layers, t, context, y):
    """The concatsquash ODEnet f(y) of y (BT, N, 3)."""
    z = y
    for i, (lp, (gate, hb)) in enumerate(zip(layers, _gates(layers, t, context))):
        z = linear(lp["_layer"], z) * gate + hb
        if i < len(layers) - 1:
            z = softplus(z)
    return z


def field_div(layers, t, context, y, e):
    """(f(y), e^T J_f(y) e) with the tangent J e carried forward."""
    zp, zt = y, e
    for i, (lp, (gate, hb)) in enumerate(zip(layers, _gates(layers, t, context))):
        w = lp["_layer"]["weight"]
        zp = linear(lp["_layer"], zp) * gate + hb
        zt = (zt @ w.T) * gate
        if i < len(layers) - 1:
            zt = zt * torch.sigmoid(zp)
            zp = softplus(zp)
    return zp, (zt * e).sum(dim=-1)


def end_time(block):
    return np.float32((block["sqrt_end_time"] * block["sqrt_end_time"]).item())


def mbn_reverse(p, s, x, eps):
    y = (x - p["bias"]) * torch.exp(-p["weight"])
    return y * torch.sqrt(s["running_var"] + eps) + s["running_mean"]


def decode(params, state, m, z, y):
    """Base samples y (B, T, N, 3) -> points at latents z (B, T, latent):
    the chain visited back to front, the CNF block integrated from 0 to its
    end time with the time-reflected field.  Returns (points, nfe)."""
    b, t, n, _ = y.shape
    bt = b * t
    context = z.reshape(bt, -1)
    chain, eps = params["point_cnf"], m["cnf_bn_eps"]
    pts = mbn_reverse(chain[2], state["point_cnf"][2], y.reshape(bt, n, 3), eps)
    block = chain[1]
    t_end = end_time(block)
    layers = block["odenet"]["layers"]

    def dynamics(s, state_):
        return (-field(layers, t_end - s, context, state_[0].reshape(bt, n, 3)).reshape(bt, -1),)

    (xs,), nfe = odeint(dynamics, (pts.reshape(bt, n * 3),), np.array([0.0, t_end], F32),
                        rtol=m["cnf_rtol"], atol=m["cnf_atol"])
    pts = mbn_reverse(chain[0], state["point_cnf"][0], xs[1].reshape(bt, n, 3), eps)
    return pts.reshape(b, t, n, 3), nfe


def reconstruct(params, state, m, x, base, max_timestamp, chunk=4):
    """(tnocs (B, T, N, 4), points (B, T, N, 3), (ode nfe, cnf nfe)) of the
    reconstruct at the observed times, from base samples ``base``."""
    z0, tnocs = encode(params, m, x, chunk)
    feats, ode_nfe = solve_latent(params, m, z0, x[:, :, 0, 3] / max_timestamp)
    pts, cnf_nfe = decode(params, state, m, feats, base)
    return tnocs, pts, (ode_nfe, cnf_nfe)


# -------------------------------------------------------------- training

def mbn_forward(p, s, x, logpx, m, train):
    """MovingBatchNorm with running statistics and its log-det; in training
    the new state moves bn_decay towards PointFlow's (transposed, reshaped)
    batch statistics."""
    eps, decay = m["cnf_bn_eps"], m["cnf_bn_decay"]
    new = s
    if train:
        with torch.no_grad():
            xt = x.transpose(0, 1).reshape(x.shape[-1], -1)
            bmean, bvar = xt.mean(dim=1), xt.var(dim=1, correction=1)
            new = {"running_mean": s["running_mean"] - decay * (s["running_mean"] - bmean),
                   "running_var": s["running_var"] - decay * (s["running_var"] - bvar),
                   "step": s["step"] + 1.0}
    half = -0.5 * torch.log(s["running_var"] + eps)
    y = (x - s["running_mean"]) * torch.exp(half) * torch.exp(p["weight"]) + p["bias"]
    return y, logpx - (half + p["weight"]).sum(), new


def likelihood(params, state, m, x, target, e, nfe_bwd):
    """The training forward: (out, new MovingBatchNorm state), out with
    'tnocs_loss' (B, T, N, 4), 'nll' (B, T, N) and 'nfe' (ode, cnf); both
    solves through the continuous adjoint."""
    b, t, n, _ = target.shape
    z0, tnocs = encode(params, m, x, chunk=len(x))
    out = {"tnocs_loss": (tnocs - target).abs()}
    feats, ode_nfe = solve_latent(params, m, z0, target[:, :, 0, 3], train=True,
                                  nfe_bwd=nfe_bwd["latent"])
    pts = target[..., :3].reshape(b * t, n, 3)
    context = feats.reshape(b * t, -1)
    chain, st = params["point_cnf"], state["point_cnf"]
    y, logp, s0 = mbn_forward(chain[0], st[0], pts, pts.new_zeros((b * t, n, 1)), m, True)
    block = chain[1]
    t_end = block["sqrt_end_time"] * block["sqrt_end_time"]
    bt = b * t

    def dynamics(tt, s_, args):
        dx, div = field_div(args[0]["layers"], tt, args[1], s_[0].reshape(bt, n, 3), e)
        return dx.reshape(bt, -1), -div

    (ys, lps), cnf_nfe = odeint_adjoint(
        dynamics, (y.reshape(bt, n * 3), logp.reshape(bt, n)), torch.stack([t_end * 0, t_end]),
        (block["odenet"], context, t_end), rtol=m["cnf_rtol"], atol=m["cnf_atol"],
        nfe_bwd=nfe_bwd["cnf"])
    y, logp, s2 = mbn_forward(chain[2], st[2], ys[1].reshape(bt, n, 3),
                              lps[1].reshape(bt, n, 1), m, True)
    log_py = (-0.5 * math.log(2 * math.pi) - y * y / 2.0).sum(dim=-1)
    out["nll"] = -(log_py - logp.reshape(bt, n)).reshape(b, t, n)
    out["nfe"] = (ode_nfe, cnf_nfe)
    return out, {**state, "point_cnf": [s0, st[1], s2]}


def leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for v in items for leaf in leaves(v)]


def train_step(params, opt, state, m, x, target, e, cnf_weight, tnocs_weight):
    """One step: the weighted losses, their gradient and one Adam update of
    ``params`` in place.  Returns (new state, {"loss", "cnf_loss",
    "tnocs_loss", "nfe_forward", "nfe_backward"})."""
    ps = leaves(params)
    for leaf in ps:
        leaf.requires_grad_(True)
    nfe_bwd = {"latent": [0.0], "cnf": [0.0]}
    with torch.enable_grad():
        out, state = likelihood(params, state, m, x, target, e, nfe_bwd)
        cnf_loss = cnf_weight * out["nll"].sum(dim=2).mean()
        tnocs_loss = tnocs_weight * out["tnocs_loss"].mean()
        grads = torch.autograd.grad(cnf_loss + tnocs_loss, ps, allow_unused=True)
    for leaf, g in zip(ps, grads):
        leaf.grad = torch.zeros_like(leaf) if g is None else g
    opt.step()
    opt.zero_grad(set_to_none=True)
    cnf_loss, tnocs_loss = cnf_loss.detach(), tnocs_loss.detach()
    return state, {"loss": float(cnf_loss + tnocs_loss), "cnf_loss": float(cnf_loss),
                   "tnocs_loss": float(tnocs_loss), "nfe_forward": out["nfe"],
                   "nfe_backward": (nfe_bwd["latent"][0], nfe_bwd["cnf"][0])}
