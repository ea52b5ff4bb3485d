"""Visualise CaSPR results with the port (headless export): the counterpart
of the JAX package's viz.py, with its flags, its flow and its scenes.

    python -m caspr_tpu_torch.cli.viz --data-cfg data/configs/demo.cfg \\
        --weights artifacts/demo_trained.pkl --seq-len 10 --num-pts 2048 \\
        --viz-tnocs --viz-observed --viz-interpolated --out ./viz_out

For each test sequence (batch 1, as in the reference viz.py:66-67) it
exports under ``--out`` the chosen scenes, each a directory of per-frame
PLY files, a standalone ``viewer.html`` and, where matplotlib imports, an
animation: ``<model>_<seq>_tnocs`` (ground truth, input and predicted
T-NOCS, optionally coloured by error), ``_observed`` (the reconstruction
at the input times) and ``_interpolated`` (at ``--num-sampled-steps``
times from 0 to 1, the observations repeated to keep pace), with the base
samples and NOCS cubes beside them.  Chamfer and EMD of the observed
reconstruction and the T-NOCS error go to ``viz_log.txt``, and so do each
scene's seconds: ``[model <scene>]`` for the work on the model's device
(ending with the copy to the host) and ``[export <scene>]`` for the files.
The base samples come from one ``torch.Generator`` seeded from ``--seed``
(the JAX package splits a key: the samples differ, the scenes do not).
The model runs on the card; ``main(argv, device="cpu")`` runs it on the
CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..data import DynamicPCLDataset, SequenceLoader
from ..models import CaSPRModel, caspr_init
from ..train import log
from ..utils.config import (apply_runtime_flags, caspr_config_from_flags, get_general_options,
                            get_viz_options)
from ..utils.evaluations import eval_reconstr_frames
from ..utils.profiling import wallclock
from ..viz import (BASE_OFFSET, PRED_OFFSET, SAMPLE_CONTOURS_RADII, export_pcl_seq,
                   get_error_colors, get_logprob_colors, get_sphere_samp_colors, np_to_list,
                   shift_pcl_list)
from ..viz.export import log_once, nocs_cube_points
from .test import load_model_weights


def interpolation_times(num: int, device=None) -> torch.Tensor:
    """``num`` float32 decode times from 0 to 1, bit for bit the JAX
    package's ``jnp.linspace(0.0, 1.0, num)``: time i is i times the float32
    reciprocal of num - 1 (XLA multiplies by it) and the last is 1.0.
    ``torch.linspace`` differs in the last bit of some (index 24 of 30)."""
    if num <= 1:
        return torch.zeros(max(num, 0), device=device)
    step = np.float32(1.0) / np.float32(num - 1)
    times = torch.arange(num - 1, dtype=torch.float32) * torch.tensor(step)
    return torch.cat([times, torch.ones(1)]).to(device)


def _with_cubes(flags, seqs, rgbs, num_frames):
    """Append GT + prediction NOCS wire-cube tracks (pcl_viewer.py:174-180
    equivalent) unless --no-nocs-cubes."""
    if not flags.show_nocs_cubes:
        return seqs, rgbs
    gt_cube = nocs_cube_points()
    pred_cube = nocs_cube_points(PRED_OFFSET)
    cube_pts = np.concatenate([gt_cube, pred_cube], axis=0)
    cube_rgb = np.full_like(cube_pts, 0.35)
    seqs = seqs + [[cube_pts] * num_frames]
    rgbs = rgbs + [[cube_rgb] * num_frames]
    return seqs, rgbs


def parse_args(argv):
    parser = argparse.ArgumentParser(allow_abbrev=False)
    parser = get_general_options(parser)
    parser = get_viz_options(parser)
    flags, _ = parser.parse_known_args(argv)
    return flags


def _contours(flags):
    return SAMPLE_CONTOURS_RADII if flags.sample_contours else None


def viz(flags, device=None):
    os.makedirs(flags.out, exist_ok=True)
    log_out = os.path.join(flags.out, "viz_log.txt")
    log(log_out, flags)
    say = lambda line: log(log_out, line)
    note = log_once(say)

    apply_runtime_flags(flags)
    cfg = caspr_config_from_flags(flags)
    model = CaSPRModel(cfg, device=device)
    generator = torch.Generator(device=model.device).manual_seed(flags.seed)
    params, state = caspr_init(generator, cfg, device=model.device)
    params, state, _ = load_model_weights(flags, params, state, log_out)

    test_dataset = DynamicPCLDataset(
        flags.data_cfg, split="test", num_pts=flags.num_pts, seq_len=flags.seq_len,
        shift_time_to_zero=(not flags.pretrain_tnocs), random_point_sample=False)
    # viz batch size is forced to 1 (reference viz.py:66-67)
    loader = SequenceLoader(test_dataset, batch_size=1, shuffle=flags.shuffle_test,
                            seed=flags.seed, num_workers=flags.num_workers)

    for i, batch in enumerate(loader):
        print("Batch: %d / %d" % (i, len(loader)))
        pcl_in_np = np.asarray(batch["input"])
        nocs_out = np.asarray(batch["target"])
        model_id, seq_id = batch["model_id"][0], batch["seq_id"][0]
        print("Model %s" % model_id)
        print("Seq %s" % seq_id)
        b, t, n, _ = pcl_in_np.shape
        scene_prefix = f"{model_id}_{seq_id}"

        tnocs_only = flags.viz_tnocs and not (flags.viz_observed or flags.viz_interpolated)
        with wallclock("model %s_%s" % (scene_prefix, "tnocs" if tnocs_only else "observed"),
                       say), torch.no_grad():
            pcl_in = torch.as_tensor(pcl_in_np, device=model.device)
            samp = logprob = pred = None
            if tnocs_only:
                _, pred_tnocs = model.encode(params, pcl_in)
            else:
                samp, logprob, pred, pred_tnocs, _ = model.reconstruct(
                    params, state, pcl_in, generator, num_points=flags.num_sampled_pts,
                    constant_in_time=flags.constant_in_time,
                    max_timestamp=test_dataset.max_timestamp, sample_contours=_contours(flags))
                samp, logprob, pred = (a.cpu().numpy() for a in (samp, logprob, pred))
            pred_tnocs_np = pred_tnocs.cpu().numpy()
            if flags.viz_observed or flags.viz_interpolated:
                qn = min(flags.num_sampled_pts, n)
                gt = nocs_out[:, :, :qn, :3].reshape(b * t, qn, 3)
                rec = pred[:, :, :qn, :].reshape(b * t, qn, 3)
                chamfer, emd = eval_reconstr_frames(rec, gt, device=model.device)

        if flags.viz_tnocs:
            nocs_err = float(np.mean(np.linalg.norm(
                pred_tnocs_np[..., :3] - nocs_out[..., :3], axis=3)))
            say("Cur L2 nocs spatial error: %f" % nocs_err)
        if flags.viz_observed or flags.viz_interpolated:
            say("Cur Mean Chamfer: %f" % (np.mean(chamfer) * 1000))
            say("Cur Mean EMD: %f" % (np.mean(emd) * 1000))

        viz_gt_nocs = np_to_list(nocs_out)
        viz_pcl_in = np_to_list(pcl_in_np)
        gt_rgb = [p.copy() for p in viz_gt_nocs]

        base_seq = [viz_gt_nocs]
        base_rgb = [gt_rgb]
        if flags.show_input_seq:
            base_seq.append(viz_pcl_in)
            base_rgb.append(gt_rgb)

        if flags.viz_tnocs:
            with wallclock(f"export {scene_prefix}_tnocs", say):
                viz_pred = np_to_list(pred_tnocs_np)
                if flags.tnocs_error_map:
                    pred_rgb = [get_error_colors(viz_pred[k], viz_gt_nocs[k]) for k in range(t)]
                else:
                    pred_rgb = [p.copy() for p in viz_pred]
                viz_pred = shift_pcl_list(viz_pred, PRED_OFFSET)
                seqs_c, rgbs_c = _with_cubes(flags, base_seq + [viz_pred], base_rgb + [pred_rgb],
                                             t)
                out = export_pcl_seq(flags.out, scene_prefix + "_tnocs", seqs_c, rgbs_c, fps=t,
                                     note=note)
            print("Exported TNOCS viz to %s" % out)

        if flags.viz_observed:
            with wallclock(f"export {scene_prefix}_observed", say):
                out = _export_reconstruction(flags, samp, logprob, pred, base_seq, base_rgb,
                                             flags.out, scene_prefix + "_observed", t, note)
            print("Exported observed reconstruction viz to %s" % out)

        if flags.viz_interpolated:
            out, _ = interpolated_scene(flags, model, params, state, pcl_in_np, nocs_out,
                                        generator, scene_prefix + "_interpolated", say, note)
            print("Exported interpolated reconstruction viz to %s" % out)


def interpolated_scene(flags, model, params, state, pcl_in_np, nocs_out, generator, name,
                       say=print, note=print):
    """The interpolated scene of one sequence (pcl_in_np, nocs_out: (1, T,
    N, 4) arrays): the reconstruction at ``--num-sampled-steps`` times from
    0 to 1 on the model's device, then its export under ``flags.out/name``,
    each timed to ``say``.  Returns (the scene's directory, (ode_nfe,
    cnf_nfe))."""
    t = nocs_out.shape[1]
    with wallclock(f"model {name}", say), torch.no_grad():
        timestamps = interpolation_times(flags.num_sampled_steps, device=model.device)
        samp, logprob, pred, _, nfe = model.reconstruct(
            params, state, torch.as_tensor(pcl_in_np, device=model.device), generator,
            timestamps=timestamps, num_points=flags.num_sampled_pts,
            constant_in_time=flags.constant_in_time, sample_contours=_contours(flags))
        samp, logprob, pred = (a.cpu().numpy() for a in (samp, logprob, pred))
    with wallclock(f"export {name}", say):
        # repeat observations to pace with interpolated steps
        # (viz_utils.py:150-174)
        reps = max(1, flags.num_sampled_steps // t)
        sub_gt, sub_in = [], []
        for ti in range(t):
            sub_gt.extend([nocs_out[0, ti, :, :3]] * reps)
            sub_in.extend([pcl_in_np[0, ti, :, :3]] * reps)
        while len(sub_gt) < flags.num_sampled_steps:
            sub_gt.append(nocs_out[0, t - 1, :, :3])
            sub_in.append(pcl_in_np[0, t - 1, :, :3])
        gt_rgb_i = [p.copy() for p in sub_gt]
        base_seq_i = [sub_gt] + ([sub_in] if flags.show_input_seq else [])
        base_rgb_i = [gt_rgb_i] * len(base_seq_i)
        out = _export_reconstruction(flags, samp, logprob, pred, base_seq_i, base_rgb_i,
                                     flags.out, name, flags.num_sampled_steps, note)
    return out, nfe


def _export_reconstruction(flags, samp, logprob, pred, base_seq, base_rgb, out_dir, name, fps,
                           note=print):
    """Compose the reconstruction scene (viz_utils.py:179-216) from the
    reconstruct's base samples, their log-probabilities and the decoded
    points (numpy arrays)."""
    viz_pred = np_to_list(pred)
    pred_rgb = [p.copy() for p in viz_pred]
    viz_samp = np_to_list(samp)
    samp_rgb = pred_rgb

    if flags.sample_contours:
        pred_rgb = samp_rgb = get_sphere_samp_colors(-logprob[0])
    elif flags.base_color_map:
        g = samp[0] / 4.5 + 0.5
        pred_rgb = samp_rgb = [g[i] for i in range(g.shape[0])]
    elif flags.prob_color_map:
        pred_rgb = samp_rgb = get_logprob_colors(-logprob[0])

    viz_pred = shift_pcl_list(viz_pred, PRED_OFFSET)
    viz_samp = [(v / 15.0) + np.array([BASE_OFFSET]) for v in viz_samp]

    seqs = base_seq + [viz_pred]
    rgbs = base_rgb + [pred_rgb]
    if flags.show_base_sampling:
        seqs.append(viz_samp)
        rgbs.append(samp_rgb)
    seqs, rgbs = _with_cubes(flags, seqs, rgbs, fps if fps > 1 else 1)
    return export_pcl_seq(out_dir, name, seqs, rgbs, fps=fps, note=note)


def main(argv=None, device=None):
    """Parse ``argv`` (default: the command line) and export the scenes,
    the model on ``device`` (default: the card)."""
    viz(parse_args(sys.argv[1:] if argv is None else argv), device=device)


if __name__ == "__main__":
    main()
