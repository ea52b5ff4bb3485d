"""The port's data parallelism on the CPU, the evaluations and the train
command line: one launch of two gloo ranks (``caspr_tpu_torch.checks.ranks``)
runs shape reconstruction, T-NOCS regression and the pose protocol over a
synthetic tree's test split, then the train CLI with --parallel, and each
is held against the one-process port in this process, with the fixtures
and bars of tests/test_torch_port_parallel.py (its docstring).  The train
steps run on a launch of their own there: under ``--dist loadfile`` the two
files run on different workers.
"""

import os

import numpy as np
import pytest

from caspr_tpu_torch.checks.ranks import run_ranks
from test_torch_port_model import TINY
from test_torch_port_parallel import (EVAL_BATCH, EVAL_BATCHES, POSE_POINT_TOL, POSE_TOL,
                                      TRAIN_ARGV, TREE_SIZES, _base_samples, _check_csv_values,
                                      _check_log, _config, _csv, check_eval_artifacts,
                                      check_train_cli, one_process_eval_logs)
from test_torch_port_parallel import one_process_cli, problem, tree  # noqa: F401 (fixtures)


@pytest.fixture(scope="module")
def two_ranks(problem, tree, tmp_path_factory):
    """One group of two gloo ranks: the three evaluations over the tree's
    test split, and the train CLI."""
    work = tmp_path_factory.mktemp("two_ranks")
    evals_out, pose_out, cli_out = str(work / "evals"), str(work / "pose"), str(work / "cli")
    os.makedirs(evals_out)
    os.makedirs(pose_out)
    parts = [
        {"job": "evals", "data_cfg": tree, "batch_size": EVAL_BATCH, "out": evals_out,
         "base_samples": _base_samples(EVAL_BATCHES), "pose_out": pose_out,
         "no_matplotlib": True},
        {"job": "cli", "cli": "train", "config": dict(TINY),
         "argv": ["--data-cfg", tree, "--out", cli_out, "--parallel", *TRAIN_ARGV]},
    ]
    results = run_ranks(2, {"job": "parts", "device": "cpu", "config": _config(problem["cfg"]),
                            "weights": problem["weights"], "parts": parts, "timeout": 300},
                        str(work / "ranks"), timeout=600)
    return dict(evals=[r[0] for r in results], cli=[r[1] for r in results],
                evals_out=evals_out, pose_out=pose_out, cli_out=cli_out)


@pytest.fixture(scope="module")
def one_process_evals(problem, tree, tmp_path_factory):
    """The three protocols in one process over the same split: shape
    reconstruction and T-NOCS regression, then the pose protocol with its
    scenes (without matplotlib, as the ranks run it) in a folder of its
    own."""
    out = str(tmp_path_factory.mktemp("evals_one"))
    pose_out = str(tmp_path_factory.mktemp("pose_one"))
    means = one_process_eval_logs(problem, tree, out, pose_out)
    return dict(out=out, means=means, pose_out=pose_out)


@pytest.mark.parametrize("stem", ["recon_log", "tnocs_log"])
def test_two_rank_evaluations_write_one_process_artifacts(two_ranks, one_process_evals, stem):
    """Shape reconstruction (observed 0, 5, 9, injected base samples) and
    T-NOCS regression over the test split, three sequences in batches of
    two: rank 1 holds a real row of the first batch and the padding of the
    second.  Rank 0 writes the one-process artifacts; rank 1 writes
    nothing."""
    got_dir = two_ranks["evals_out"]
    assert sorted(os.listdir(got_dir)) == sorted(
        f"{s}.{ext}" for s in ("recon_log", "tnocs_log") for ext in ("txt", "npz", "csv"))
    check_eval_artifacts(got_dir, one_process_evals["out"], stem)
    if stem == "tnocs_log":
        for r in two_ranks["evals"]:
            np.testing.assert_allclose(r["tnocs_means"], one_process_evals["means"], rtol=1e-6)


def _ply_points(path):
    with open(path) as f:
        head, body = f.read().split("end_header\n")
    return head, np.array([line.split() for line in body.splitlines()], float)


@pytest.mark.parametrize("what", ["artifacts", "scenes"])
def test_two_rank_pose_protocol_writes_one_process_artifacts(two_ranks, one_process_evals,
                                                             what):
    """The pose protocol with its scenes over the same split: rank 1's real
    row (of the first batch) is RANSAC-seeded by its global row, its frame
    errors gathered in global row order, and its scene exported by rank 1.
    Rank 0 writes the one-process .txt / .npz / .csv; rank 1 logs only to
    rank1_pose_log.txt; together the ranks write the one-process scenes.

    Bars: the errors within POSE_TOL, the scenes' points within
    POSE_POINT_TOL (the module's docstring)."""
    got_dir, want_dir = two_ranks["pose_out"], one_process_evals["pose_out"]
    scenes = sorted(d for d in os.listdir(want_dir) if os.path.isdir(os.path.join(want_dir, d)))
    assert len(scenes) == TREE_SIZES["test"]
    if what == "artifacts":
        assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir) + ["rank1_pose_log.txt"])
        got_stem, want_stem = (os.path.join(d, "pose_log_RANSAC") for d in (got_dir, want_dir))
        got, want = np.load(got_stem + ".npz"), np.load(want_stem + ".npz")
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].shape == want[k].shape == (TREE_SIZES["test"] * 10,), k
            np.testing.assert_allclose(got[k], want[k], rtol=POSE_TOL, atol=POSE_TOL, err_msg=k)
        rows, want_rows = _csv(got_stem + ".csv"), _csv(want_stem + ".csv")
        assert [r[:2] for r in rows] == [r[:2] for r in want_rows]
        assert len(rows) == TREE_SIZES["test"] + 1
        _check_csv_values(rows, want_rows, 2, POSE_TOL)
        _check_log(os.path.join(got_dir, "pose_log.txt"), os.path.join(want_dir, "pose_log.txt"),
                   POSE_TOL)
        rank1 = open(os.path.join(got_dir, "rank1_pose_log.txt")).read()
        assert "RANSAC" not in rank1
    else:
        for scene in scenes:
            files = sorted(os.listdir(os.path.join(want_dir, scene)))
            assert sorted(os.listdir(os.path.join(got_dir, scene))) == files
            assert files == [f"frame_{i:04d}.ply" for i in range(10)] + ["viewer.html"]
            for name in files[:-1]:
                got, want = (_ply_points(os.path.join(d, scene, name))
                             for d in (got_dir, want_dir))
                assert got[0] == want[0] and got[1].shape == want[1].shape
                np.testing.assert_allclose(got[1], want[1], rtol=0, atol=POSE_POINT_TOL,
                                           err_msg=f"{scene}/{name}")


@pytest.mark.parametrize("what", ["files", "checkpoint", "log"])
def test_two_rank_train_cli(two_ranks, one_process_cli, what):
    """The train CLI with --parallel on two ranks, one epoch of one step
    and a validation: rank 0 writes the checkpoints, the curve and
    train_log.txt, rank 1 only rank1_train_log.txt; the checkpoint's
    parameters (moved by their gradient: Adam at beta 0 and lr = eps =
    1e10) are the one-process CLI's within the gradient bars."""
    check_train_cli(two_ranks["cli_out"], one_process_cli, two_ranks["cli"], what,
                    "2 devices, axes ('dp',) (2,)")
