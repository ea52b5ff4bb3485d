"""The paper's evaluation protocols (counterpart of
caspr_tpu/utils/evaluations.py): shape reconstruction with Chamfer and EMD
per frame, T-NOCS regression, and camera pose from T-NOCS by RANSAC.

The artifacts are those of the JAX package: the same log lines (errors
x1000 where it prints them so), the same ``.npz`` keys, the same CSV
headers and row order.  A loader is any iterable with ``len`` that yields
dicts of numpy arrays: "input" and "target" (B, 10, 2048, 4), "model_id"
and "seq_id" lists, optionally "valid" (the real rows of a padded batch)
and, for the pose protocol, "pose" (B, 10, 4, 4).  Batches go to the
model's device; statistics are taken on the host.  ``show=True`` exports
each sequence's pose scene (``viz.export_pcl_seq``) beside the log.

``mesh`` (a ``parallel.make_mesh`` mesh) shards the evaluation over the
ranks: the loader gives each rank its rows (``SequenceLoader(num_shards=,
shard_index=, pad_last=True)`` over the batch group, with "valid_global",
the real rows of the global batch), each rank evaluates its rows, and the
per-row results and sequence ids are gathered in global row order over the
batch group.  With sp a rank also takes its range of the input's points:
shape reconstruction decodes point-sharded and gathers the decoded clouds
over the point group, in rank order, before Chamfer and EMD, which need
whole clouds (each rank of the point group scores its share of the
frames, and the scores are gathered); T-NOCS regression gathers its
per-point errors.  Every
rank then holds the one-process run's statistics; rank 0 of the whole
group alone logs them and writes the ``.txt`` / ``.npz`` / ``.csv``.  The
pose protocol encodes each rank's rows whole (the encoder reads whole
clouds), and its RANSAC runs on the point group's rank 0 over its rows,
seeded by their global index, which exports its own sequences' scenes.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Sequence

import numpy as np
import torch

from ..models.caspr import resolve_device
from ..ops import approx_match_emd, chamfer_distance
from ..parallel.mesh import (all_gather_cat, all_gather_objects, broadcast,
                             group_rank_size, is_lead, mesh_groups, shard_batch_points,
                             shard_points)
from ..train.trackers import log
from ..viz.export import export_pcl_seq, log_once
from .ransac import ransac_rigid_registration

# the protocol of the paper's evaluations
PROTOCOL_NUM_STEPS = 10
PROTOCOL_NUM_PTS = 2048

ALL_OBSERVED_STEPS = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9]
ALL_UNOBSERVED_STEPS = []
SPLIT_OBSERVED_STEPS = [0, 5, 9]
SPLIT_UNOBSERVED_STEPS = [1, 2, 3, 4, 6, 7, 8]


def _recon_metrics(pred, gt):
    """pred, gt (F, N, 3) tensors -> (chamfer (F,), emd (F,)): the two-way
    squared nearest-neighbour means added, and the EMD cost over N."""
    pred, gt = pred.contiguous(), gt.contiguous()
    d1, d2 = chamfer_distance(pred, gt)
    return d1.mean(dim=1) + d2.mean(dim=1), approx_match_emd(pred, gt) / pred.shape[1]


def _recon_metrics_over(pred, gt, point):
    """``_recon_metrics`` of F frame pairs of whole clouds that every rank
    of ``point`` holds alike, each rank scoring its share of the frames
    (ceil(F / size), the last frame repeated to fill the share) and the
    shares gathered in rank order; or ``_recon_metrics`` without a group."""
    if point is None:
        return _recon_metrics(pred, gt)
    rank, size = group_rank_size(point)
    frames = pred.shape[0]
    share = -(-frames // size)
    mine = torch.arange(rank * share, (rank + 1) * share, device=pred.device).clamp(max=frames - 1)
    got = torch.stack(_recon_metrics(pred[mine], gt[mine]))
    return tuple(all_gather_cat(got, point, "eval", dim=1)[:, :frames])


def eval_reconstr_frames(pred, gt, device=None):
    """pred, gt: (F, N, 3) arrays -> (chamfer (F,), emd (F,)) as numpy,
    computed on ``device`` (default: the card)."""
    dev = resolve_device(device)
    to = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev).contiguous()
    with torch.no_grad():
        chamfer, emd = _recon_metrics(to(pred), to(gt))
    return chamfer.cpu().numpy(), emd.cpu().numpy()


def _check_protocol(t, n):
    if t != PROTOCOL_NUM_STEPS:
        raise ValueError(f"Test protocol requires {PROTOCOL_NUM_STEPS} steps, got {t}")
    if n != PROTOCOL_NUM_PTS:
        raise ValueError(f"Test protocol requires {PROTOCOL_NUM_PTS} points, got {n}")


def _batch_ids(batch, model_ids, seq_ids, group=None):
    """Record the real rows' ids (of the global batch, gathered, with a
    process group); returns the number of real rows."""
    if group is None:
        valid = batch.get("valid", len(batch["input"]))
        model_ids.extend(batch["model_id"][:valid])
        seq_ids.extend(batch["seq_id"][:valid])
        return valid
    parts = all_gather_objects((list(batch["model_id"]), list(batch["seq_id"])), group, "ids")
    models = [m for part in parts for m in part[0]]
    # "valid" is the global count where the loader has one shard (dp 1)
    valid = batch.get("valid_global", batch.get("valid", len(models)))
    model_ids.extend(models[:valid])
    seq_ids.extend([q for part in parts for q in part[1]][:valid])
    return valid


def _rows_of(x, group):
    """The rows of every rank in global row order (a tensor), or x."""
    return x if group is None else all_gather_cat(x, group, "eval")


def _whole_points(x, point):
    """Every rank's points of the same rows along axis 2, in rank order, or x."""
    return x if point is None else all_gather_cat(x, point, "eval", dim=2)


def _quiet(*_args):
    """The stand-in of print and log on a rank that does not write."""


def _per_seq(values, num_seqs, steps):
    return np.array(values).reshape(num_seqs, steps).mean(axis=1)


def _csv_writer(csvfile):
    return csv.writer(csvfile, delimiter=",", quotechar="|", quoting=csv.QUOTE_MINIMAL)


@torch.no_grad()
def test_shape_recon(model, params, state, loader, log_out, observed_steps: Sequence[int],
                     unobserved_steps: Sequence[int], generator=None, base_samples=None,
                     mesh=None):
    """Shape reconstruction: encode the observed steps, decode all ten, and
    score the observed and the unobserved steps apart.

    ``generator`` draws the decoder's base samples (default: seed 0 on the
    model's device); ``base_samples``, an iterable of one (B, 10, 2048, 3)
    array per batch (the global batch's, with a ``mesh``), replaces the
    draw.  The decode times are the first row's of the (global) batch."""
    groups = mesh_groups(mesh)
    group, point = (None, None) if groups is None else (groups.batch, groups.point)
    lead = groups is None or is_lead(groups.whole)
    say, show = (log, print) if lead else (_quiet, _quiet)
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    base_samples = None if base_samples is None else iter(base_samples)
    observed_steps, unobserved_steps = list(observed_steps), list(unobserved_steps)
    use_unobserved = len(unobserved_steps) > 0
    say(log_out, "Observed steps [%s]" % ",".join(str(i) for i in observed_steps))
    say(log_out, "Unobserved steps [%s]" % ",".join(str(i) for i in unobserved_steps))

    nfe_stats = []
    model_ids, seq_ids = [], []
    observed_stats = {"chamfer": [], "emd": [], "infer_time": []}
    unobserved_stats = {"chamfer": [], "emd": []}
    t_obs, t_unobs = len(observed_steps), len(unobserved_steps)

    def dispatch(batch):
        """Enqueue one batch's device work (reconstruct and both metric
        legs); its results stay on the device."""
        pcl_in = torch.as_tensor(batch["input"], device=model.device)
        nocs_out = torch.as_tensor(batch["target"], device=model.device)
        b, t, n, _ = pcl_in.shape
        valid = _batch_ids(batch, model_ids, seq_ids, group)
        _check_protocol(t, n)
        base = None
        if base_samples is not None:
            base = next(base_samples)
            base = torch.as_tensor(base if mesh is None else shard_batch_points(mesh, base),
                                   device=model.device)
        timestamps = nocs_out[0, :, 0, 3]
        if groups is not None:
            timestamps = broadcast(timestamps.contiguous(), groups.whole, "eval")
            pcl_in = shard_points(mesh, pcl_in)
        _, _, pred, _, nfe = model.reconstruct(
            params, state, pcl_in[:, observed_steps].contiguous(), generator,
            num_points=PROTOCOL_NUM_PTS, timestamps=timestamps,
            constant_in_time=False, base_samples=base, groups=groups)
        pred = _whole_points(pred, point)

        def score(steps):
            gt = nocs_out[:, steps, :, :3].reshape(b * len(steps), n, 3)
            return _recon_metrics_over(pred[:, steps].reshape(b * len(steps), n, 3), gt, point)

        out = {"nfe": nfe, "valid": valid, "obs": score(observed_steps)}
        if use_unobserved:
            out["unobs"] = score(unobserved_steps)
        return out

    def drain(pend, elapsed):
        """Read a dispatched batch's results back and fold them into the
        running statistics: the point where the host waits for the device."""
        valid = pend["valid"]
        nfe_stats.append([float(pend["nfe"][0]), float(pend["nfe"][1])])
        chamfer, emd = (_rows_of(x, group).cpu().numpy() for x in pend["obs"])
        observed_stats["chamfer"].extend(chamfer[: valid * t_obs].tolist())
        observed_stats["emd"].extend(emd[: valid * t_obs].tolist())
        observed_stats["infer_time"].append(elapsed)

        show("==== OBSERVED ====")
        show("Shape Recon Mean Chamfer: %f" % (np.mean(observed_stats["chamfer"]) * 1000))
        show("Shape Recon Median Chamfer: %f" % (np.median(observed_stats["chamfer"]) * 1000))
        show("Shape Recon Mean EMD: %f" % (np.mean(observed_stats["emd"]) * 1000))
        show("Shape Recon Median EMD: %f" % (np.median(observed_stats["emd"]) * 1000))
        show("NFE Mean: (%f, %f)" % tuple(np.mean(nfe_stats, axis=0).tolist()))
        show("Infer time mean: %f" % np.mean(observed_stats["infer_time"]))

        if use_unobserved:
            chamfer, emd = (_rows_of(x, group).cpu().numpy() for x in pend["unobs"])
            unobserved_stats["chamfer"].extend(chamfer[: valid * t_unobs].tolist())
            unobserved_stats["emd"].extend(emd[: valid * t_unobs].tolist())
            show("==== UNOBSERVED ====")
            show("Shape Recon Mean Chamfer: %f" % (np.mean(unobserved_stats["chamfer"]) * 1000))
            show("Shape Recon Mean EMD: %f" % (np.mean(unobserved_stats["emd"]) * 1000))

    # Depth-1 pipeline: batch i's metric kernels are enqueued (nothing waits
    # for them) and batch i+1 is dispatched before batch i's results are
    # read back, so the card works through the metrics while the host
    # prepares the next batch.  The per-batch infer_time is drain-to-drain
    # wall clock.
    pending = None
    t_mark = time.time()
    for i, batch in enumerate(loader):
        show("Batch: %d / %d" % (i, len(loader)))
        cur = dispatch(batch)
        if pending is not None:
            drain(pending, time.time() - t_mark)
            t_mark = time.time()
        pending = cur
    if pending is not None:
        drain(pending, time.time() - t_mark)
    if not lead:
        return

    stats_list = [observed_stats, unobserved_stats] if use_unobserved else [observed_stats]
    stats_names = ["OBSERVED", "UNOBSERVED"] if use_unobserved else ["OBSERVED"]
    for stat_dict, name in zip(stats_list, stats_names):
        log(log_out, "================  %s SAMPLING RECONSTR EVAL =====================" % name)
        for label, key in (("CHAMFER", "chamfer"), ("EMD", "emd")):
            log(log_out, "mean %s error (x1000): %f +- %f, median: %f" % (
                label, np.mean(stat_dict[key]) * 1000.0, np.std(stat_dict[key]) * 1000.0,
                np.median(stat_dict[key]) * 1000.0))
    log(log_out, "NFE Mean: (%f, %f)" % tuple(np.mean(nfe_stats, axis=0).tolist()))
    log(log_out, "mean Inference time: %f" % np.mean(observed_stats["infer_time"]))

    np.savez(
        log_out[: -len("txt")] + "npz",
        observed_chamfer=observed_stats["chamfer"],
        observed_emd=observed_stats["emd"],
        unobserved_chamfer=unobserved_stats["chamfer"],
        unobserved_emd=unobserved_stats["emd"],
    )

    per_seq_log = log_out[: -len("txt")] + "csv"
    print("Per seq performance being saved to %s..." % per_seq_log)
    with open(per_seq_log, "w", newline="") as csvfile:
        w = _csv_writer(csvfile)
        w.writerow(["type", "model_id", "seq_id", "chamfer", "emd"])
        for stat_dict, name, steps_t in zip(stats_list, stats_names, [t_obs, t_unobs]):
            per_seq_chamfer = _per_seq(stat_dict["chamfer"], len(model_ids), steps_t)
            per_seq_emd = _per_seq(stat_dict["emd"], len(model_ids), steps_t)
            for li in range(len(model_ids)):
                w.writerow([name, model_ids[li], seq_ids[li], per_seq_chamfer[li],
                            per_seq_emd[li]])


@torch.no_grad()
def test_tnocs_regression(model, params, state, loader, log_out, mesh=None):
    """T-NOCS regression: mean spatial (L2) and time (absolute) error of the
    encoder's per-point prediction.  Returns the two means (of the whole
    split on every rank, with a ``mesh``)."""
    groups = mesh_groups(mesh)
    group, point = (None, None) if groups is None else (groups.batch, groups.point)
    lead = groups is None or is_lead(groups.whole)
    show = print if lead else _quiet
    model_ids, seq_ids = [], []
    stat_dict = {"space": [], "time": []}
    last_t = PROTOCOL_NUM_STEPS
    for i, batch in enumerate(loader):
        show("Batch: %d / %d" % (i, len(loader)))
        pcl_in = torch.as_tensor(batch["input"], device=model.device)
        nocs_out = torch.as_tensor(batch["target"], device=model.device)
        _, last_t, n, _ = pcl_in.shape
        valid = _batch_ids(batch, model_ids, seq_ids, group)
        _check_protocol(last_t, n)

        if groups is not None:
            pcl_in, nocs_out = shard_points(mesh, (pcl_in, nocs_out))
        _, pred_tnocs = model.encode(params, pcl_in, point)
        dist = _whole_points(torch.linalg.vector_norm(pred_tnocs[..., :3] - nocs_out[..., :3],
                                                      dim=3), point).mean(dim=2)
        stat_dict["space"].extend(_rows_of(dist, group).cpu().numpy()[:valid].reshape(-1).tolist())
        if pred_tnocs.shape[-1] > 3:
            tdiff = _whole_points((pred_tnocs[..., 3] - nocs_out[..., 3]).abs(), point).mean(dim=2)
            stat_dict["time"].extend(
                _rows_of(tdiff, group).cpu().numpy()[:valid].reshape(-1).tolist())

        show("==== CURRENT ERROR ====")
        show("mean SPATIAL error (l2 distance) %f" % np.mean(stat_dict["space"]))
        show("mean TIME error (absolute diff): : %f" % np.mean(stat_dict["time"]))

    if not lead:
        return np.mean(stat_dict["space"]), np.mean(stat_dict["time"])
    log(log_out, "================  TNOCS REGRESSION EVAL =====================")
    for label, key in (("SPATIAL error (l2 distance)", "space"),
                       ("TIME error (absolute diff)", "time")):
        log(log_out, "mean %s: %f +- %f, median: %f" % (
            label, np.mean(stat_dict[key]), np.std(stat_dict[key]), np.median(stat_dict[key])))
    np.savez(log_out[: -len("txt")] + "npz", space=stat_dict["space"], time=stat_dict["time"])
    per_seq_log = log_out[: -len("txt")] + "csv"
    print("Per seq performance being saved to %s..." % per_seq_log)
    with open(per_seq_log, "w", newline="") as csvfile:
        w = _csv_writer(csvfile)
        w.writerow(["model_id", "seq_id", "space", "time"])
        per_seq_space = _per_seq(stat_dict["space"], len(model_ids), last_t)
        per_seq_time = _per_seq(stat_dict["time"], len(model_ids), last_t)
        for li in range(len(model_ids)):
            w.writerow([model_ids[li], seq_ids[li], per_seq_space[li], per_seq_time[li]])
    return np.mean(stat_dict["space"]), np.mean(stat_dict["time"])


def _camera_frustum_points(transform, scale=0.1, color=(0.0, 1.0, 0.0)):
    """Point-sampled camera frustum + trajectory marker for a 4x4 camera
    pose (headless analogue of pcl_viewer.py:193-206)."""
    apex = np.zeros(3)
    corners = (
        np.array(
            [[-1, -0.75, 1.5], [1, -0.75, 1.5], [1, 0.75, 1.5], [-1, 0.75, 1.5]]
        )
        * scale
    )
    t = np.linspace(0, 1, 8)[:, None]
    segs = [apex * (1 - t) + c * t for c in corners]
    for a, b in zip(corners, np.roll(corners, 1, axis=0)):
        segs.append(a * (1 - t) + b * t)
    pts = np.concatenate(segs, axis=0)
    r, tr = transform[:3, :3], transform[:3, 3]
    world = pts @ r.T + tr
    return world, np.tile(np.asarray(color)[None], (world.shape[0], 1))


def _export_pose_scene(out_dir, name, pred_nocs, pred_nocs_rgb, pred_depth,
                       gt_depth, gt_nocs, gt_cams, pred_cams, note=print):
    """Headless stand-in for the reference's interactive pose visualization
    (evaluations.py:435-458): predicted NOCS in T-NOCS RGB, GT NOCS
    transformed by the predicted pose (blue), GT input/NOCS (green), plus
    green GT and red predicted camera frusta."""
    t = len(pred_nocs)
    blue = [np.tile([[0.0, 0.0, 1.0]], (p.shape[0], 1)) for p in pred_depth]
    green = [np.tile([[0.0, 1.0, 0.0]], (p.shape[0], 1)) for p in gt_depth]
    cam_tracks = []
    cam_rgbs = []
    for cams, color in ((gt_cams, (0.0, 1.0, 0.0)), (pred_cams, (1.0, 0.0, 0.0))):
        frames = [_camera_frustum_points(c, color=color) for c in cams]
        cam_tracks.append([f[0] for f in frames])
        cam_rgbs.append([f[1] for f in frames])
    return export_pcl_seq(
        out_dir,
        name,
        [pred_nocs, pred_depth, gt_depth, gt_nocs] + cam_tracks,
        [pred_nocs_rgb, blue, green, green] + cam_rgbs,
        fps=t,
        note=note,
    )


@torch.no_grad()
def test_observed_camera_pose_ransac(model, params, state, loader, log_out, show: bool = False,
                                     mesh=None):
    """Camera pose from the predicted T-NOCS by correspondence RANSAC on the
    host (threshold 0.015, 4-point samples, 50000 iterations / 5000
    validations), against the batch's ground-truth poses.  ``show`` exports
    each sequence's pose scene, ``pose_<model>_<seq>``, next to the log.
    With sp, the ranks of a point group encode the same rows, and its rank
    0 alone runs their RANSAC and exports their scenes."""
    groups = mesh_groups(mesh)
    group = None if groups is None else groups.batch
    lead = groups is None or is_lead(groups.whole)
    registers = groups is None or is_lead(groups.point)  # runs RANSAC on the rank's rows
    echo = print if lead else _quiet
    rank = group_rank_size(group)[0]
    loader.dataset.set_return_pose_data(True)
    note = log_once(lambda line: log(log_out, line))

    model_ids, seq_ids = [], []
    stat_dict = {"trans_RANSAC": [], "rot_RANSAC": [], "point_RANSAC": [],
                 "point_mean_RANSAC": []}
    num_steps = PROTOCOL_NUM_STEPS

    for i, batch in enumerate(loader):
        echo("Batch: %d / %d" % (i, len(loader)))
        pcl_in = np.asarray(batch["input"])
        nocs_out = np.asarray(batch["target"])
        pose_data = np.asarray(batch["pose"])
        b, num_steps, n, _ = pcl_in.shape
        _batch_ids(batch, model_ids, seq_ids, group)
        valid = batch.get("valid", b)  # this rank's real rows
        _check_protocol(num_steps, n)

        _, pred_tnocs = model.encode(params, torch.as_tensor(pcl_in, device=model.device))
        pred_tnocs = pred_tnocs.cpu().numpy()
        found = {k: [] for k in stat_dict}

        for bi in range(valid if registers else 0):
            row = rank * b + bi  # the row's index in the global batch
            norm_pred = pred_tnocs[bi, :, :, :3] - 0.5
            norm_gt = nocs_out[bi, :, :, :3] - 0.5
            inputs = pcl_in[bi, :, :, :3]
            scene = {"pred_depth": [], "gt_depth": [], "gt_cams": [], "pred_cams": []}
            for si in range(num_steps):
                trans = ransac_rigid_registration(
                    norm_pred[si], inputs[si], max_corr_dist=0.015, ransac_n=4,
                    max_iteration=50000, max_validation=5000,
                    seed=i * 1000 + row * num_steps + si)
                r_pred, t_pred = trans[:3, :3], trans[:3, 3]
                r_gt, t_gt = pose_data[bi, si, :3, :3], pose_data[bi, si, :3, 3]
                # point errors from the ground-truth NOCS, so that the
                # regression's error does not compound
                pred_depth = norm_gt[si] @ r_pred.T + t_pred
                dists = np.linalg.norm(pred_depth - inputs[si], axis=1)
                found["point_RANSAC"].append(float(np.median(dists)))
                found["point_mean_RANSAC"].append(float(np.mean(dists)))
                rot_diff = (np.trace(r_pred.T @ r_gt) - 1.0) / 2.0
                rot_err = np.degrees(np.arccos(np.clip(rot_diff, -1.0, 1.0)))
                found["trans_RANSAC"].append(float(np.linalg.norm(t_pred - t_gt)))
                found["rot_RANSAC"].append(float(rot_err))

                if show:
                    scene["pred_depth"].append(pred_depth)
                    scene["gt_depth"].append(norm_gt[si] @ r_gt.T + t_gt)
                    for key, r_, t_ in (("gt_cams", r_gt, t_gt), ("pred_cams", r_pred, t_pred)):
                        cam = np.eye(4)
                        cam[:3, :3] = r_.T
                        cam[:3, 3] = r_.T @ -t_
                        scene[key].append(cam)

            if show:
                out = _export_pose_scene(
                    os.path.dirname(log_out),
                    f"pose_{batch['model_id'][bi]}_{batch['seq_id'][bi]}",
                    [norm_pred[si] for si in range(num_steps)],
                    [pred_tnocs[bi, si, :, :3] for si in range(num_steps)],
                    scene["pred_depth"], scene["gt_depth"],
                    [norm_gt[si] for si in range(num_steps)],
                    scene["gt_cams"], scene["pred_cams"], note=note)
                print("Exported pose viz to %s" % out)

        # every rank's frames in global row order (the batch groups of the
        # point groups' rank 0 gather them)
        parts = [found] if group is None or not registers else all_gather_objects(found, group,
                                                                                  "eval")
        for part in parts:
            for k in stat_dict:
                stat_dict[k].extend(part[k])
        echo("==== CURRENT ERROR ====")
        echo("mean Pos error RANSAC (l2 distance) %f" % np.mean(stat_dict["trans_RANSAC"]))
        echo("mean Rot error RANSAC (degrees): %f" % np.mean(stat_dict["rot_RANSAC"]))
        echo("mean-median Point error RANSAC (L2 distance): %f" % np.mean(stat_dict["point_RANSAC"]))
        echo("mean-mean Point error RANSAC (L2 distance): %f" % np.mean(stat_dict["point_mean_RANSAC"]))

    if not lead:
        return

    for label, key in [
        ("POS error RANSAC (l2 distance)", "trans_RANSAC"),
        ("ROT error RANSAC (degrees)", "rot_RANSAC"),
        ("POINT(median) error RANSAC (l2 distance)", "point_RANSAC"),
        ("POINT(mean) error RANSAC (l2 distance)", "point_mean_RANSAC"),
    ]:
        vals = stat_dict[key]
        log(log_out, "mean %s: %f +- %f, median: %f" % (
            label, np.mean(vals), np.std(vals), np.median(vals)))

    np.savez(
        log_out[: -len(".txt")] + "_RANSAC.npz",
        trans=stat_dict["trans_RANSAC"],
        rot=stat_dict["rot_RANSAC"],
        point=stat_dict["point_RANSAC"],
        point_mean=stat_dict["point_mean_RANSAC"],
    )
    per_seq_log = log_out[: -len(".txt")] + "_RANSAC.csv"
    print("Per seq performance of RANSAC being saved to %s..." % per_seq_log)
    with open(per_seq_log, "w", newline="") as csvfile:
        w = _csv_writer(csvfile)
        w.writerow(["model_id", "seq_id", "pos", "rot", "point"])
        per_seq = [_per_seq(stat_dict[k], len(model_ids), num_steps)
                   for k in ("trans_RANSAC", "rot_RANSAC", "point_RANSAC")]
        for li in range(len(model_ids)):
            w.writerow([model_ids[li], seq_ids[li]] + [col[li] for col in per_seq])
