"""The port's point parallelism (``--sp-size``, the ``(dp, sp)`` and ``(dcn,
dp, sp)`` meshes of caspr_tpu_torch/parallel) on the CPU, at the TINY
configuration of tests/test_torch_port_model.py with the radii of
tests/test_torch_port_train_step.py.  One launch of four gloo ranks
(``caspr_tpu_torch.checks.ranks``) carries every job, in one process group:
the meshes and their groups, ``shard_batch_points`` and the command lines'
loader shards; a ``(dp 2, sp 2)`` train step, with the continuous adjoint
and with the discrete backward, on the batch of two of
tests/test_torch_port_train_step.py (one row a dp rank, 24 of its 48 points
a rank); the shape-reconstruction and T-NOCS evaluations over a
synthetic tree's test split of two sequences, one batch of two (one row a
dp rank, 1024 of 2048 points a rank; tests/test_torch_port_parallel_evals.py
holds a padded batch to the one-process run); and a reconstruct of that
batch of two with the reference-parity decode (``sample_div=True``, one
injected Hutchinson noise, each rank its rows and points of it), against
the one-process reconstruct at equal NFE and 1e-4
(tests/test_torch_port_sample_div.py's bars).  The command lines with
--sp-size run on the card (chip_smoke.py phase 11).

Each is held against the one-process port in this process with the bars of
tests/test_torch_port_parallel.py (its docstring), from which this file
takes its fixtures and bars, and the adjoint step also against the JAX
package's step on ``make_mesh(jax.devices()[:4], sp_size=2)`` with the bars
of tests/test_torch_port_train_step.py.  A fault of the sums over ranks
shows in the gradient: the context's cotangent not summed over the point
group sends the sp ranks' latent adjoints apart (other NFE, or a hang that
the groups' deadline ends), and what a point group holds alike counted on
every one of its ranks doubles the encoder's and the latent ODE's leaves.
"""

import argparse
import os

import numpy as np
import pytest
import torch

import jax

from caspr_tpu.parallel import make_mesh as jax_make_mesh
from caspr_tpu.parallel import shard_batch_points as jax_shard_batch_points
from caspr_tpu_torch.checks.ranks import run_ranks
from caspr_tpu_torch.data import write_synthetic_tree
from caspr_tpu_torch.models.caspr import CaSPRModel
from caspr_tpu_torch.utils import config
from caspr_tpu_torch.weights import params_from_jax
from test_torch_port_parallel import (EVAL_BATCH, EVAL_BATCHES, _base_samples, _check_against,
                                      _config, check_against_jax_step, check_eval_artifacts,
                                      jax_mesh_train_step, one_process_eval_logs,
                                      one_process_steps)
from test_torch_port_parallel import jax_problem  # noqa: F401 (a fixture)

CASES = {"adjoint": {}, "discrete": {"ode_backward": "discrete"}}
# a tree of two test sequences (the train and val splits go unread): the
# approxmatch EMD of every frame (on the CPU, about 1.3 s a pair on one
# thread) is most of an evaluation's time
TREE_SIZES = {"train": 2, "val": 2, "test": 2}
# (num_slices, sp_size) of the meshes the launch makes
MESHES = {"dp2_sp2": (1, 2), "dcn2_dp1_sp2": (2, 2)}
# a (B, T, N, C) leaf, a (B, T) leaf and a 0-d leaf for shard_batch_points
ARRAY = {"x": np.arange(4 * 3 * 8 * 2).reshape(4, 3, 8, 2), "t": np.arange(12).reshape(4, 3),
         "s": np.float32(2)}
# the sample-div reconstruct: the steps' input clouds (2 x 3 x 48), decoded
# at three times from base samples and a noise of 48 points, 24 a sp rank
_rng = np.random.default_rng(14)
SAMPLE_DIV = {"timestamps": np.linspace(0.0, 1.0, 3, dtype=np.float32),
              "base": _rng.standard_normal((2, 3, 48, 3)).astype(np.float32),
              "e": _rng.standard_normal((2 * 3, 48, 3)).astype(np.float32), "sample_div": True}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_synthetic_tree(str(tmp_path_factory.mktemp("tree")), seed=9, num_pts=2048,
                                split_sizes=TREE_SIZES)


@pytest.fixture(scope="module")
def sp_ranks(jax_problem, tree, tmp_path_factory):
    """The one launch of four gloo ranks on a (dp 2, sp 2) mesh."""
    work = tmp_path_factory.mktemp("sp_ranks")
    evals_out = str(work / "evals")
    os.makedirs(evals_out)
    parts = [
        {"job": "mesh", "meshes": list(MESHES.values()), "array": ARRAY, "sp_size": 2},
        {"job": "steps", "cases": [dict(x=jax_problem["x"], target=jax_problem["target"],
                                        e=jax_problem["e"], **case) for case in CASES.values()]},
        {"job": "evals", "data_cfg": tree, "batch_size": EVAL_BATCH, "out": evals_out,
         "base_samples": _base_samples(EVAL_BATCHES)},
        dict(job="reconstruct", x=jax_problem["x"], **SAMPLE_DIV),
    ]
    results = run_ranks(4, {"job": "parts", "device": "cpu", "sp_size": 2,
                            "config": _config(jax_problem["cfg"]),
                            "weights": jax_problem["weights"], "parts": parts, "timeout": 300},
                        str(work / "ranks"), timeout=600)
    return dict(mesh=[r[0] for r in results], steps=[r[1] for r in results],
                evals=[r[2] for r in results], evals_out=evals_out,
                sample_div=[r[3] for r in results])


@pytest.fixture(scope="module")
def one_process(jax_problem):
    """The one-process port step of each case on the batch of two."""
    return one_process_steps(jax_problem, CASES)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sp_mesh_groups(sp_ranks, mesh):
    """The axes, ``sp`` innermost, and each rank's groups: the batch group
    the ranks of its sp index, the point group its consecutive pair, the
    whole group every rank."""
    got = [r["meshes"][list(MESHES).index(mesh)] for r in sp_ranks["mesh"]]
    names, shape = {"dp2_sp2": (("dp", "sp"), (2, 2)),
                    "dcn2_dp1_sp2": (("dcn", "dp", "sp"), (2, 1, 2))}[mesh]
    for rank, g in enumerate(got):
        assert g["names"] == names
        assert g["describe"] == f"4 devices, axes {names} {shape}"
        assert g["batch"] == [rank % 2, rank % 2 + 2]
        assert g["point"] == [rank // 2 * 2, rank // 2 * 2 + 1]
        assert g["whole"] == [0, 1, 2, 3]


def test_sp_shard_batch_points(sp_ranks):
    """Rank r holds rows 2 (r // 2) and 2 (r // 2) + 1, and points 4 (r %
    2) to 4 (r % 2) + 3 of them; (B, T) leaves are cut by rows, 0-d leaves
    kept."""
    for rank, r in enumerate(sp_ranks["mesh"]):
        rows = slice(rank // 2 * 2, rank // 2 * 2 + 2)
        points = slice(rank % 2 * 4, rank % 2 * 4 + 4)
        assert np.array_equal(r["shard"]["x"], ARRAY["x"][rows, :, points])
        assert np.array_equal(r["shard"]["t"], ARRAY["t"][rows])
        assert r["shard"]["s"] == ARRAY["s"]


def test_sp_loader_shards_over_dp(sp_ranks):
    """The command lines' loaders shard over the batch group: two shards,
    the dp rank's; the ranks of a point group load the same rows.  Rank i
    > 0 logs to rank<i>_<log>."""
    for rank, r in enumerate(sp_ranks["mesh"]):
        assert r["shards"] == {"num_shards": 2, "shard_index": rank // 2}
        assert r["log_name"] == ("log.txt" if rank == 0 else f"rank{rank}_log.txt")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("what", ["metrics", "grads", "state", "ranks_equal"])
def test_sp_step_matches_one_process_step(sp_ranks, one_process, case, what):
    """The (dp 2, sp 2) step against the one-process step of the same batch
    of two: NFE equal on every rank and to the one-process step's, the
    gradients within GRAD_TOL, the MovingBatchNorm state within 1e-5
    relative, the ranks bit-equal."""
    ranks = [r[list(CASES).index(case)] for r in sp_ranks["steps"]]
    _check_against(ranks, one_process[case], what)


@pytest.fixture(scope="module")
def jax_sp_mesh_step(jax_problem):
    """The JAX package's train step on make_mesh(jax.devices()[:4],
    sp_size=2), the batch's rows over dp and its points over sp (as
    tests/test_parallel.py builds the mesh)."""
    mesh = jax_make_mesh(jax.devices()[:4], sp_size=2)
    assert mesh.axis_names == ("dp", "sp")
    return jax_mesh_train_step(jax_problem, mesh, jax_shard_batch_points)


@pytest.mark.parametrize("what", ["metrics", "params", "state"])
def test_sp_step_matches_jax_mesh_step(sp_ranks, jax_problem, jax_sp_mesh_step, what):
    """The hold against the reference: the same weights, the JAX step's own
    noise fed to the ranks' rows and points through e=."""
    check_against_jax_step(jax_problem, sp_ranks["steps"][0][0], jax_sp_mesh_step, what)


def test_sp_collectives_counted(sp_ranks):
    """The kinds sp adds, alike on every rank: one gather of the encoder's
    input, the MovingBatchNorm's points and rows (two gathers a layer), the
    context's VJP over the point group at each backward evaluation of the
    CNF (adjoint) or once (discrete), the gradient over every rank."""
    adjoint, discrete = ([r[i] for r in sp_ranks["steps"]] for i in range(2))
    counts = adjoint[0]["collectives"]
    assert all(r["collectives"] == counts for r in adjoint)
    b, t, n = 1, 3, 24  # a rank's rows, frames and points
    assert counts["points"] == {"calls": 1, "bytes": b * t * n * 4 * 4}
    assert counts["mbn"]["calls"] == 4
    assert counts["grad"]["calls"] == 1
    assert counts["grad"]["bytes"] == 4 * sum(v.size for v in adjoint[0]["params"].values())
    assert counts["adjoint_ctx"]["calls"] > 10 and counts["adjoint_vjp"]["calls"] > 10
    assert "discrete_ctx" not in counts
    counts = discrete[0]["collectives"]
    assert counts["discrete_ctx"]["calls"] == 1 and "adjoint_ctx" not in counts


def test_sp_sample_div_reconstruct_matches_one_process(sp_ranks, jax_problem):
    """Each rank's rows and points of the sample-div decode against the
    one-process reconstruct (rank r: dp r // 2, sp r % 2, sp innermost)."""
    cfg = jax_problem["cfg"]
    params, state = params_from_jax(jax_problem["weights"]["params"],
                                    jax_problem["weights"]["state"], cfg, device="cpu")
    x = jax_problem["x"]
    with torch.no_grad():
        _, _, want, _, nfe = CaSPRModel(cfg, device="cpu").reconstruct(
            params, state, torch.from_numpy(x), None, num_points=x.shape[2],
            timestamps=torch.from_numpy(SAMPLE_DIV["timestamps"]),
            base_samples=torch.from_numpy(SAMPLE_DIV["base"]), sample_div=True,
            e=torch.from_numpy(SAMPLE_DIV["e"]))
    n = x.shape[2] // 2
    for rank, got in enumerate(sp_ranks["sample_div"]):
        dp, sp = divmod(rank, 2)
        assert got["nfe"] == nfe, rank
        np.testing.assert_allclose(got["points"], want[dp:dp + 1, :, sp * n:(sp + 1) * n].numpy(),
                                   rtol=0, atol=1e-4)
        assert got["collectives"], rank  # the error norms ran over the group


@pytest.fixture(scope="module")
def one_process_evals(jax_problem, tree, tmp_path_factory):
    """Shape reconstruction and T-NOCS regression in one process over the
    same split (the weights are those of the steps' problem, which do not
    depend on its batch)."""
    out = str(tmp_path_factory.mktemp("evals_one"))
    return dict(out=out, means=one_process_eval_logs(jax_problem, tree, out))


@pytest.mark.parametrize("stem", ["recon_log", "tnocs_log"])
def test_sp_evaluations_write_one_process_artifacts(sp_ranks, one_process_evals, stem):
    """Shape reconstruction (observed 0, 5, 9, injected base samples) and
    T-NOCS regression over the test split, two sequences in a batch of two,
    on (dp 2, sp 2): each rank decodes 1024 of a cloud's 2048 points, and
    scores its half of its row's frames.  Rank 0 writes the one-process
    artifacts within 1e-5; no other rank writes."""
    got_dir = sp_ranks["evals_out"]
    assert sorted(os.listdir(got_dir)) == sorted(
        f"{s}.{ext}" for s in ("recon_log", "tnocs_log") for ext in ("txt", "npz", "csv"))
    check_eval_artifacts(got_dir, one_process_evals["out"], stem, TREE_SIZES["test"])
    if stem == "tnocs_log":
        for r in sp_ranks["evals"]:
            np.testing.assert_allclose(r["tnocs_means"], one_process_evals["means"], rtol=1e-6)


@pytest.mark.parametrize("flags, world, node, protocol, match", [
    (dict(sp_size=2, use_parallel=False), 1, None, None, "--sp-size 2 requires --parallel"),
    (dict(sp_size=3), 4, None, None, "--sp-size 3 does not divide the 4 ranks of a node"),
    (dict(sp_size=2), 8, 2, None, None),
    (dict(sp_size=4), 8, 2, None, "--sp-size 4 does not divide the 2 ranks of a node"),
    (dict(sp_size=2, batch_size=3), 4, None, None,
     "--batch-size 3 is not divisible by the 2 dp ranks (4 ranks / --sp-size 2)"),
    (dict(sp_size=2, num_pts=63), 4, None, None, "--num-pts 63 is not divisible by --sp-size 2"),
    (dict(sp_size=3, num_pts=3072), 6, None, 2048,
     "the protocol's points 2048 is not divisible by --sp-size 3"),
])
def test_sp_flag_checks(flags, world, node, protocol, match, monkeypatch):
    """``utils.config.check_flags`` before any process group: the world
    size (WORLD_SIZE) and a node's (LOCAL_WORLD_SIZE) that sp must divide,
    the batch the dp ranks must divide, the points sp must divide; a
    ValueError names the flag."""
    monkeypatch.setenv("WORLD_SIZE", str(world))
    if node is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(node))
    args = argparse.Namespace(**{"use_parallel": True, "batch_size": 4, "num_pts": 64,
                                 "multihost": False, **flags})
    if match is None:
        config.check_flags(args, protocol)
    else:
        with pytest.raises(ValueError, match=match.replace("(", r"\(").replace(")", r"\)")):
            config.check_flags(args, protocol)
