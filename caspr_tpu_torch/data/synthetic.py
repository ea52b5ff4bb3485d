"""A synthetic dataset tree in the format of the demo data, written from a
seed, for runs where no real sequences are at hand.

    <root>/synthetic.cfg                   --data, --splits, --max-timestamp,
                                           --expected-num-pts, --expected-seq-len
    <root>/splits/{train,val,test}_split.txt
    <root>/data/<model>/seq_00000000/seq_00000000_frame_<i>.npz

Each model is an ellipsoid's surface in the unit cube (its NOCS); each
frame holds ``num_pts`` fresh samples of it as ``nocs_data``, the same
points under the frame's rigid pose (a turn about the vertical axis that
grows over the sequence, and a translation) as ``depth_data`` = R (nocs -
0.5) + t, and that pose as ``obj_T``.  The split counts are sequences that
the loader keeps; beside them the tree holds what it must skip: in the
test split, a model whose frames hold fewer points (repeat-padded by the
loader), a second sequence of ``seq_len - 1`` frames (filtered out by the
expected length) and a model listed in ``BAD_MODELS``.
"""

from __future__ import annotations

import os

import numpy as np

from .dataset import BAD_MODELS

SPLIT_SIZES = {"train": 10, "val": 5, "test": 6}
MAX_TIMESTAMP = 5.0


def _frames(rng, num_frames: int, num_pts: int):
    """(nocs (F, P, 3), depth (F, P, 3), pose (F, 4, 4)) of one sequence."""
    axes = rng.uniform(0.2, 0.45, size=3)
    turn = rng.uniform(0.1, 0.4)
    start = rng.uniform(0.0, 2.0 * np.pi)
    drift = rng.uniform(-0.1, 0.1, size=3)
    nocs, depth, pose = [], [], []
    for i in range(num_frames):
        d = rng.standard_normal((num_pts, 3))
        pts = 0.5 + axes * d / np.linalg.norm(d, axis=1, keepdims=True)
        a = start + turn * i
        r = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                      [-np.sin(a), 0.0, np.cos(a)]])
        t = np.array([0.0, 0.0, 1.5]) + drift * i
        p = np.eye(4)
        p[:3, :3], p[:3, 3] = r, t
        nocs.append(pts)
        depth.append((pts - 0.5) @ r.T + t)
        pose.append(p)
    return (np.asarray(nocs, np.float32), np.asarray(depth, np.float32),
            np.asarray(pose, np.float32))


def _write_sequence(seq_dir: str, rng, num_frames: int, num_pts: int):
    os.makedirs(seq_dir, exist_ok=True)
    name = os.path.basename(seq_dir)
    nocs, depth, pose = _frames(rng, num_frames, num_pts)
    for i in range(num_frames):
        np.savez(os.path.join(seq_dir, f"{name}_frame_{i:03d}.npz"),
                 nocs_data=nocs[i], depth_data=depth[i], obj_T=pose[i])


def write_synthetic_tree(root: str, seed: int = 0, num_pts: int = 4096, seq_len: int = 10,
                         split_sizes=None) -> str:
    """Write the tree under ``root``; returns the path of its .cfg.
    ``split_sizes`` ({split: sequences kept}, default ``SPLIT_SIZES``)."""
    sizes = dict(SPLIT_SIZES if split_sizes is None else split_sizes)
    rng = np.random.default_rng(seed)
    data_dir, split_dir = os.path.join(root, "data"), os.path.join(root, "splits")
    os.makedirs(split_dir, exist_ok=True)
    short_pts = max(1, num_pts * 3000 // 4096)
    for split, count in sizes.items():
        models = [f"{split}_{i:04d}" for i in range(count)]
        for i, model in enumerate(models):
            pts = short_pts if split == "test" and i == count - 1 else num_pts
            _write_sequence(os.path.join(data_dir, model, "seq_00000000"), rng, seq_len, pts)
        if split == "test" and count:
            _write_sequence(os.path.join(data_dir, models[0], "seq_00000001"), rng,
                            seq_len - 1, num_pts)
            _write_sequence(os.path.join(data_dir, BAD_MODELS[0], "seq_00000000"), rng,
                            seq_len, num_pts)
            models.insert(1, BAD_MODELS[0])
        with open(os.path.join(split_dir, f"{split}_split.txt"), "w") as f:
            f.write("\n".join(models) + "\n")
    cfg = os.path.join(root, "synthetic.cfg")
    with open(cfg, "w") as f:
        f.write(f"--data {os.path.abspath(data_dir)}\n--splits {os.path.abspath(split_dir)}\n"
                f"--max-timestamp {MAX_TIMESTAMP}\n--expected-num-pts {num_pts}\n"
                f"--expected-seq-len {seq_len}\n")
    return cfg
