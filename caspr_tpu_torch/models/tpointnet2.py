"""TPointNet++ encoder (counterpart of caspr_tpu/models/tpointnet2.py):
a global space-time PointNet over all T*N (x, y, z, t) points, a per-frame
PointNet++ over augmented xyz, two 1x1-conv + GroupNorm(16) fusion layers
to the per-point latent, a sigmoid T-NOCS head, and a max to z0."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..nn import conv1x1, group_norm
from .pointnet import pointnetfeat_apply_split, pointnetfeat_param_shapes
from .pointnet2 import PointNet2Config, pointnet2_apply, pointnet2_param_shapes

NUM_GROUPS = 16


@dataclass(frozen=True)
class TPointNet2Config:
    radii_list: Tuple[float, ...] = (0.02, 0.05, 0.1, 0.2, 0.4, 0.8)
    local_feat_size: int = 512
    out_feat_size: int = 1600
    augment_quad: bool = True
    augment_pairs: bool = True
    tnocs_point_size: int = 4
    regress_tnocs: bool = True
    global_feat_size: int = 1024
    space_time_pt_feat: int = 64
    sa_points: Tuple[int, ...] = (1024, 512, 256, 64, 16)
    ball_samples: Tuple[int, int] = (16, 32)
    sa_impl: str = "xla"  # how each SA scale runs: see models/pointnet2.py

    def pointnet2_config(self) -> PointNet2Config:
        in_features = (3 if self.augment_quad else 0) + (3 if self.augment_pairs else 0)
        return PointNet2Config(
            in_features=in_features,
            num_classes=self.local_feat_size,
            max_feat_prop_size=self.local_feat_size,
            radii_list=tuple(self.radii_list),
            sa_points=tuple(self.sa_points),
            ball_samples=tuple(self.ball_samples),
            sa_impl=self.sa_impl,
        )

    @property
    def per_point_out_size(self) -> int:
        return self.global_feat_size + self.space_time_pt_feat + self.local_feat_size


def tpointnet2_param_shapes(cfg: TPointNet2Config):
    d = cfg.per_point_out_size
    shapes = {
        "local_extract": pointnet2_param_shapes(cfg.pointnet2_config()),
        "global_extract": pointnetfeat_param_shapes(input_dim=4, out_size=cfg.global_feat_size),
        "conv1": {"weight": (d, d), "bias": (d,)},
        "conv2": {"weight": (cfg.out_feat_size, d), "bias": (cfg.out_feat_size,)},
        "bn1": {"weight": (d,), "bias": (d,)},
        "bn2": {"weight": (cfg.out_feat_size,), "bias": (cfg.out_feat_size,)},
    }
    if cfg.regress_tnocs:
        shapes["conv3"] = {"weight": (cfg.tnocs_point_size, cfg.out_feat_size),
                           "bias": (cfg.tnocs_point_size,)}
    return shapes


def augment_input(spatial, augment_quad: bool, augment_pairs: bool):
    """Channels x, y, z, x^2, y^2, z^2, xz, xy, yz (the reference's order)."""
    parts = [spatial]
    if augment_quad:
        parts.append(spatial * spatial)
    if augment_pairs:
        x, y, z = spatial[..., 0:1], spatial[..., 1:2], spatial[..., 2:3]
        parts.extend([x * z, x * y, z * y])
    return torch.cat(parts, dim=-1)


def tpointnet2_apply(params, cfg: TPointNet2Config, x):
    """x: (B, T, N, 4) -> (z0 (B, out_feat), tnocs (B, T, N, 4) or None)."""
    b, t, n, _ = x.shape
    global_in = x.reshape(b, t * n, 4)
    spatial = x.reshape(b * t, n, 4)[..., :3]
    local_in = augment_input(spatial, cfg.augment_quad, cfg.augment_pairs)
    local_feat = pointnet2_apply(params["local_extract"], cfg.pointnet2_config(), local_in)
    local_feat = local_feat.reshape(b, t * n, cfg.local_feat_size)

    # Factored fusion conv1.  Its input channels are [local | global | point];
    # the global block is the same for every point of a sequence, so its
    # weight columns are applied once per sequence to the (B, 1024) vector.
    gvec, point_feat = pointnetfeat_apply_split(params["global_extract"], global_in)
    dl, dg = cfg.local_feat_size, cfg.global_feat_size
    w = params["conv1"]["weight"]
    h = (
        conv1x1({"weight": w[:, :dl]}, local_feat)
        + conv1x1({"weight": w[:, dl + dg:]}, point_feat)
        + conv1x1({"weight": w[:, dl:dl + dg], "bias": params["conv1"]["bias"]}, gvec)[:, None, :]
    )
    feat = torch.relu(group_norm(params["bn1"], h, NUM_GROUPS))
    feat = group_norm(params["bn2"], conv1x1(params["conv2"], feat), NUM_GROUPS)

    tnocs = None
    if cfg.regress_tnocs:
        tnocs_out = conv1x1(params["conv3"], torch.relu(feat))
        tnocs = torch.sigmoid(tnocs_out[..., :cfg.tnocs_point_size])
        tnocs = tnocs.reshape(b, t, n, cfg.tnocs_point_size)
    return feat.amax(dim=1), tnocs
