"""PointNet++ multi-scale-grouping backbone (counterpart of
caspr_tpu/models/pointnet2.py): five set-abstraction (SA) levels with two
grouping scales each, five feature-propagation (FP) levels, and a
conv-GN-ReLU-conv head.

Per SA level: FPS, the dual-radius ball query, and per scale the grouping,
a mini-PointNet and a max (ops/sa_fused.py), computed as
``PointNet2Config.sa_impl`` says.  The JAX package's selections are config
fields here, each defaulting to what the port ran before they existed:

  - ``sa_impl`` (its ``CASPR_TPU_SA``): "xla", the plain composition;
    "factored", conv1 factored through the gather (the JAX package's
    default on its TPU); "fused", one kernel per scale (csrc/sa_fused.cu).
    The JAX package's fused, fused2 and fused3 (its v1, v2 and v3 Pallas
    kernels, which compute the same values) are all served by that one
    kernel, which computes the factored (v2 / v3) arithmetic.  A scale
    the kernel does not take falls to "factored" if it has three convs,
    else to "xla", as the JAX package's fused3 branch does;
  - ``fps`` (``CASPR_TPU_FPS``): "hier", one FPS per cloud, since once one
    real FPS has run each later level's centroids are a prefix of its
    FPS-ordered input; "level", an FPS per level;
  - ``factored_fp`` (``CASPR_TPU_FACTORED_FP``): 3-NN interpolation is
    linear with scalar weights, so conv1(concat([interp(F), skip])) ==
    interp(F @ Wi^T) + skip @ Ws^T + b and the wide matmul runs on the
    coarse level's points;
  - ``bq_pair`` (``CASPR_TPU_BQ_PAIR``): both radii of a level from one
    ball-query launch, or one launch per radius (the same indices).

The point-cloud primitives come from ``ops`` and run the CUDA kernels for
CUDA tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from ..nn import conv1x1, group_norm
from ..ops import (
    ball_query,
    ball_query_pair,
    farthest_point_sampling,
    gather_points,
    group_points,
    three_interpolate,
    three_nn,
)
from ..ops.sa_fused import (
    NUM_GROUPS,
    can_fuse,
    fused_sa_scale,
    mini_pointnet_apply,
    sa_scale_factored,
)

SA_IMPLS = ("xla", "factored", "fused")
FPS_MODES = ("hier", "level")


@dataclass(frozen=True)
class SALevel:
    num_points_out: int
    scales: Tuple[Tuple[float, int, Tuple[int, ...]], ...]  # (radius, K, mlp)


@dataclass(frozen=True)
class PointNet2Config:
    in_features: int = 6
    num_classes: int = 512
    max_feat_prop_size: int = 512
    radii_list: Tuple[float, ...] = (0.02, 0.05, 0.1, 0.2, 0.4, 0.8)
    use_xyz_feature: bool = True
    sa_points: Tuple[int, ...] = (1024, 512, 256, 64, 16)
    ball_samples: Tuple[int, int] = (16, 32)
    sa_impl: str = "xla"
    fps: str = "hier"
    factored_fp: bool = True
    bq_pair: bool = True

    def __post_init__(self):
        if self.sa_impl not in SA_IMPLS:
            raise ValueError(f"sa_impl={self.sa_impl!r}: expected one of {SA_IMPLS}")
        if self.fps not in FPS_MODES:
            raise ValueError(f"fps={self.fps!r}: expected one of {FPS_MODES}")

    def sa_levels(self) -> List[SALevel]:
        r = self.radii_list
        p = self.sa_points
        k1, k2 = self.ball_samples
        return [
            SALevel(p[0], ((r[0], k1, (16, 16, 32)), (r[1], k2, (32, 32, 64)))),
            SALevel(p[1], ((r[1], k1, (32, 32, 64)), (r[2], k2, (32, 32, 64)))),
            SALevel(p[2], ((r[2], k1, (64, 64, 128)), (r[3], k2, (64, 96, 128)))),
            SALevel(p[3], ((r[3], k1, (128, 256, 256)), (r[4], k2, (128, 256, 256)))),
            SALevel(p[4], ((r[4], k1, (256, 256, 512)), (r[5], k2, (256, 256, 512)))),
        ]

    def sa_out_dims(self) -> List[int]:
        return [sum(s[2][-1] for s in lvl.scales) for lvl in self.sa_levels()]

    def fp_dims(self) -> List[Tuple[int, List[int]]]:
        """[(in_features, layer_dims)] of the five FP levels."""
        sa_out = self.sa_out_dims()
        mfp, nc = self.max_feat_prop_size, self.num_classes
        dims = [max(mfp, nc), max(mfp, nc), max(mfp // 2, nc), max(mfp // 2, nc),
                max(mfp // 4, nc)]
        skips = [sa_out[3], sa_out[2], sa_out[1], sa_out[0], self.in_features]
        prev = [sa_out[4]]
        specs = []
        for i in range(5):
            specs.append((skips[i] + prev[-1], [dims[i]] * 2))
            prev.append(dims[i])
        return specs


def _stack_shapes(in_ch: int, dims: Sequence[int]):
    all_dims = [in_ch] + list(dims)
    return {
        "convs": [{"weight": (all_dims[i + 1], all_dims[i]), "bias": (all_dims[i + 1],)}
                  for i in range(len(dims))],
        "norms": [{"weight": (d,), "bias": (d,)} for d in dims],
    }


def pointnet2_param_shapes(cfg: PointNet2Config):
    shapes = {"set_abstractions": [], "feature_propagators": []}
    in_ch = cfg.in_features + (3 if cfg.use_xyz_feature else 0)
    for lvl in cfg.sa_levels():
        shapes["set_abstractions"].append(
            {"scales": [_stack_shapes(in_ch, dims) for (_, _, dims) in lvl.scales]})
        in_ch = sum(s[2][-1] for s in lvl.scales) + (3 if cfg.use_xyz_feature else 0)
    for fp_in, fp_dims in cfg.fp_dims():
        shapes["feature_propagators"].append(_stack_shapes(fp_in, fp_dims))
    final_in = cfg.fp_dims()[-1][1][-1]
    shapes["final_conv1"] = {"weight": (final_in, final_in), "bias": (final_in,)}
    shapes["final_norm"] = {"weight": (final_in,), "bias": (final_in,)}
    shapes["final_conv2"] = {"weight": (cfg.num_classes, final_in), "bias": (cfg.num_classes,)}
    return shapes


def _sa_impl(cfg: PointNet2Config, sp, k: int) -> str:
    """How one SA scale runs: "xla" | "factored" | "fused" (see the module
    docstring); without relative-xyz features every mode runs "xla"."""
    if not cfg.use_xyz_feature:
        return "xla"
    if cfg.sa_impl == "fused" and can_fuse(sp, k):
        return "fused"
    if cfg.sa_impl in ("fused", "factored") and len(sp["convs"]) == 3:
        return "factored"
    return "xla"


def pointnet2_apply(params, cfg: PointNet2Config, points):
    """points: (B, N, 3 + in_features) -> per-point features (B, N, num_classes)."""
    xyz = points[..., :3].contiguous()
    features = points[..., 3:] if points.shape[-1] > 3 else None

    xyz_list = [xyz]
    feat_list = [features]
    fps_ordered = False  # is `xyz` in FPS selection order?
    for lvl, lvl_params in zip(cfg.sa_levels(), params["set_abstractions"]):
        m, n = lvl.num_points_out, xyz.shape[1]
        if cfg.fps == "hier" and fps_ordered and m <= n:
            new_xyz = xyz[:, :m].contiguous()
        else:
            idx = farthest_point_sampling(xyz, m)
            new_xyz = gather_points(xyz, idx)
            if m < n:
                fps_ordered = True  # gather order = FPS selection order
            elif m > n:
                fps_ordered = False  # repeat-padded: ordering broken
        if len(lvl.scales) == 2 and cfg.bq_pair:
            (r1, k1, _), (r2, k2, _) = lvl.scales
            gidxs = list(ball_query_pair(xyz, new_xyz, r1, k1, r2, k2))
        else:
            gidxs = [ball_query(xyz, new_xyz, radius, k) for (radius, k, _) in lvl.scales]
        scale_feats = []
        for (_, k, _), sp, gidx in zip(lvl.scales, lvl_params["scales"], gidxs):
            impl = _sa_impl(cfg, sp, k)
            if impl == "fused":
                scale_feats.append(fused_sa_scale(sp, xyz, features, new_xyz, gidx))
            elif impl == "factored":
                scale_feats.append(sa_scale_factored(sp, xyz, features, new_xyz, gidx,
                                                     gather=gather_points))
            else:
                grouped = group_points(xyz, new_xyz, features, gidx, cfg.use_xyz_feature,
                                       gather=gather_points)  # (B, M, K, C_in)
                b, mm, kk, cin = grouped.shape
                h = mini_pointnet_apply(sp, grouped.reshape(b * mm, kk, cin))
                scale_feats.append(h.reshape(b, mm, -1))
        features = torch.cat(scale_feats, dim=-1)
        xyz = new_xyz
        xyz_list.append(xyz)
        feat_list.append(features)

    # feature propagation from the coarsest level back to the input points
    target = len(xyz_list) - 2
    for fp_params in params["feature_propagators"]:
        d2, idx = three_nn(xyz_list[target], xyz_list[target + 1])
        inv = 1.0 / (d2 + 1e-8)
        w = inv / inv.sum(dim=-1, keepdim=True)
        src = feat_list[target + 1]
        skip = feat_list[target]
        conv0 = fp_params["convs"][0]
        c_src = src.shape[-1]
        if cfg.factored_fp and conv0["weight"].shape[0] <= c_src:
            g = conv1x1({"weight": conv0["weight"][:, :c_src]}, src)
            h = three_interpolate(g.contiguous(), idx, w.contiguous())
            if skip is not None:
                h = h + conv1x1({"weight": conv0["weight"][:, c_src:]}, skip)
            h = h + conv0["bias"]
            h = torch.relu(group_norm(fp_params["norms"][0], h, NUM_GROUPS))
            for conv, norm in zip(fp_params["convs"][1:], fp_params["norms"][1:]):
                h = torch.relu(group_norm(norm, conv1x1(conv, h), NUM_GROUPS))
        else:
            interp = three_interpolate(src.contiguous(), idx, w.contiguous())
            h = interp if skip is None else torch.cat([interp, skip], dim=-1)
            for conv, norm in zip(fp_params["convs"], fp_params["norms"]):
                h = torch.relu(group_norm(norm, conv1x1(conv, h), NUM_GROUPS))
        feat_list[target] = h
        target -= 1

    h = torch.relu(group_norm(params["final_norm"],
                              conv1x1(params["final_conv1"], feat_list[0]), NUM_GROUPS))
    return conv1x1(params["final_conv2"], h)
