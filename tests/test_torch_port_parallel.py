"""The port's data parallelism (caspr_tpu_torch/parallel) on the CPU: ranks
are gloo processes of their own (``caspr_tpu_torch.checks.ranks``: fresh
interpreters that import the port alone, a FileStore under tmp_path for the
rendezvous, a deadline on every group), and each run is held against the
one-process port in this process, and once against the JAX package's train
step on a 2-device ``make_mesh``, at the TINY configuration of
tests/test_torch_port_model.py with the radii of
tests/test_torch_port_train_step.py.  This file runs the train steps and
the mesh's unit tests; tests/test_torch_port_parallel_evals.py the
evaluations and the train CLI on two ranks, and tests/test_torch_port_sp.py
point parallelism, each on a launch of its own (under ``--dist loadfile``
each file runs on one worker), with the fixtures and bars of this file.

A step across R ranks must compute what the one-process step computes on
the same global batch.  Tolerances:
  - NFE, forward and forward + adjoint per solver: equal on every rank (the
    error norms are global, so the ranks take the same steps) and to the
    one-process step's.  The second holds where no accept decision sits
    within rounding of its threshold: the ranks compute the dynamics on
    fewer rows, which rounds otherwise than the one-process products, and
    the first steps' error estimates are rounding noise (as between the
    card and the CPU, or the port and the JAX package).  This problem's
    decisions are clear of it; at seed 21, for one, a CNF step's error
    ratio is 1.0017 in one process against 0.9978 on two ranks;
  - parameters after the step: ``torch.equal`` on every rank (the gradient
    is one all-reduce, whose result every rank shares);
  - losses and logged scalars: 1e-5 relative (the global values are sums
    of the ranks' shares, in another order than the one-process means);
  - gradients (the update is SGD with rate 1, so the recorded gradient and
    params - grads are the gradient): each leaf within GRAD_TOL of
    tests/test_torch_port_train_step.py, rel * its largest + floor * its
    module's largest (the encoder's conv biases ahead of a GroupNorm have a
    gradient of 0 in exact arithmetic, and float32 noise);
  - MovingBatchNorm state: 1e-5 relative (its statistics are the
    one-process ones, taken on the gathered rows, which the ranks computed
    on fewer rows a product);
  - against the JAX package's mesh step: the bars of
    tests/test_torch_port_train_step.py (its _check_metrics and
    _check_params, state 1e-4 relative);
  - evaluations: the same rows (ids, counts) and values within 1e-5,
    absolute or relative (the random weights reconstruct with Chamfer
    distances near 40, whose float32 rounding is 4e-6);
  - the pose protocol: its errors (.npz, .csv, .txt) within 1e-4, absolute
    or relative, and its scenes' points within 2e-4.  The ranks' encoder
    rounds otherwise on fewer rows, RANSAC's pose moves with its input,
    and rotation errors near 180 degrees, where arccos is steep, amplify
    that: 1.3e-5 relative on a rotation error and 6.1e-5 on a scene's
    point were measured.  A RANSAC seed taken from the rank's own row
    index, or the ranks' frame errors gathered out of order, moves them by
    0.2 and 2.0.
"""

import dataclasses
import functools
import os
import re
import sys

import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from caspr_tpu.models.caspr import CaSPRConfig as JaxConfig
from caspr_tpu.models.caspr import CaSPRModel as JaxModel
from caspr_tpu.models.caspr import caspr_init as jax_caspr_init
from caspr_tpu.parallel import make_mesh as jax_make_mesh
from caspr_tpu.parallel import replicate as jax_replicate
from caspr_tpu.parallel import shard_batch as jax_shard_batch
from caspr_tpu.train import loop as jloop
from caspr_tpu_torch import parallel
from caspr_tpu_torch.checks.ranks import RecordingOptimizer, run_ranks
from caspr_tpu_torch.cli import test as cli_test
from caspr_tpu_torch.cli import train as cli_train
from caspr_tpu_torch.data import DynamicPCLDataset, SequenceLoader, write_synthetic_tree
from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel, caspr_init
from caspr_tpu_torch.ops.odeint import flatten_tree
from caspr_tpu_torch.train import make_train_step
from caspr_tpu_torch.train.checkpoint import _flatten, _merge, load_checkpoint
from caspr_tpu_torch.utils import config
from caspr_tpu_torch.utils import evaluations as ev
from caspr_tpu_torch.weights import params_from_jax
from test_torch_port_adjoint import _stop_gradient_noise
from test_torch_port_model import CLOUD_SIZE, DEFAULT_THREADS, TINY, _numpy_weights, torch_threads
from test_torch_port_train_step import GRAD_TOL, TRAIN, _check_metrics, _check_params

B, T, N = 4, 3, 48
# the problem of tests/test_torch_port_train_step.py (its seed), at B = 4
SEED = 11
CNF_W, TNOCS_W = 0.01, 100.0
RADII = ["0.08", "0.12", "0.18", "0.25", "0.4", "0.8"]
TREE_SIZES = {"train": 4, "val": 4, "test": 3}
EVAL_BATCH = 2
CASES = {"adjoint": {}, "discrete": {"ode_backward": "discrete"}, "accum2": {"accum_steps": 2}}
# Adam with beta1 = beta2 = 0 and lr = eps = 1e10 moves a weight by
# g * 1e10 / (|g| + 1e10): by its gradient, to float32 rounding
SGD1_ADAM = ["--lr", "1e10", "--eps", "1e10", "--beta1", "0", "--beta2", "0"]
TRAIN_ARGV = ["--seq-len", "3", "--num-pts", "64", "--batch-size", "4", "--epochs", "1",
              "--val-every", "1", "--save-every", "1", "--print-every", "1", "--radii", *RADII,
              *SGD1_ADAM]


def _config(cfg: CaSPRConfig) -> dict:
    return dataclasses.asdict(cfg)


def _problem(b):
    """Weights (numpy, the JAX package's layout), a global batch of b and
    the Hutchinson noise the JAX package's train step draws for it, made
    as tests/test_torch_port_train_step.py makes them (the weights do not
    depend on b)."""
    jcfg = JaxConfig(**TRAIN)
    shapes = jax.eval_shape(functools.partial(jax_caspr_init, cfg=jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(SEED)
    params_np = _numpy_weights(shapes[0], rng)
    state_np = _numpy_weights(shapes[1], rng, "/point_cnf")
    x = rng.random((b, T, N, 4), dtype=np.float32)
    x[..., :3] *= CLOUD_SIZE
    x[..., 3] = np.linspace(0.0, 5.0, T, dtype=np.float32)[None, :, None]
    target = rng.random((b, T, N, 4), dtype=np.float32)
    target[..., 3] = np.sort(rng.random((b, T), dtype=np.float32), axis=1)[:, :, None]
    key = jax.random.PRNGKey(SEED)
    e = np.asarray(jax.random.normal(jax.random.split(key, 1)[0], (b * T, N, 3)))
    return dict(weights={"params": params_np, "state": state_np}, x=x, target=target, e=e,
                key=key, cfg=CaSPRConfig(**TRAIN))


@pytest.fixture(scope="module")
def problem():
    return _problem(B)


@pytest.fixture(scope="module")
def jax_problem():
    """tests/test_torch_port_train_step.py's own batch of two, one row a
    rank: the port's one-process step holds to the JAX package's there."""
    return _problem(2)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_synthetic_tree(str(tmp_path_factory.mktemp("tree")), seed=9, num_pts=2048,
                                split_sizes=TREE_SIZES)


def _base_samples(num_batches):
    rng = np.random.default_rng(5)
    return [rng.standard_normal((EVAL_BATCH, 10, ev.PROTOCOL_NUM_PTS, 3)).astype(np.float32)
            for _ in range(num_batches)]


# the test split is three sequences in batches of EVAL_BATCH: the first
# batch is whole (one real row a rank), the second padded (rank 1's row)
EVAL_BATCHES = 2
# the pose protocol's bars (the module's docstring)
POSE_TOL, POSE_POINT_TOL = 1e-4, 2e-4


def _cases(*problems):
    return [dict(x=p["x"], target=p["target"], e=p["e"], **CASES.get(name, {}))
            for p, name in zip(problems, list(CASES) + ["jax"])]


@pytest.fixture(scope="module")
def two_ranks(problem, jax_problem, tmp_path_factory):
    """One group of two gloo ranks: the three train steps of CASES, and
    the step held to the JAX package's."""
    work = tmp_path_factory.mktemp("two_ranks")
    results = run_ranks(2, {"job": "steps", "device": "cpu", "config": _config(problem["cfg"]),
                            "weights": problem["weights"],
                            "cases": _cases(problem, problem, problem, jax_problem),
                            "timeout": 300}, str(work), timeout=600)
    return dict(steps=results)


@pytest.fixture(scope="module")
def four_ranks(problem, tmp_path_factory):
    """One adjoint step on a (dcn 2, dp 2) mesh of four gloo ranks."""
    work = tmp_path_factory.mktemp("four_ranks")
    cases = [dict(x=problem["x"], target=problem["target"], e=problem["e"])]
    results = run_ranks(4, {"job": "steps", "device": "cpu", "config": _config(problem["cfg"]),
                            "weights": problem["weights"], "cases": cases, "num_slices": 2,
                            "timeout": 300}, str(work), timeout=600)
    return [r[0] for r in results]


def one_process_steps(problem, cases):
    """The one-process port step of each case of ``cases`` ({name: case})
    on the problem's whole batch."""
    cfg = problem["cfg"]
    model = CaSPRModel(cfg, device="cpu")
    out = {}
    for name, case in cases.items():
        params, state = params_from_jax(problem["weights"]["params"],
                                        problem["weights"]["state"], cfg, device="cpu")
        leaves = flatten_tree(params)[0]
        opt = RecordingOptimizer(torch.optim.SGD(leaves, lr=1.0), leaves)
        step = make_train_step(model, None, CNF_W, TNOCS_W,
                               accum_steps=case.get("accum_steps", 1),
                               ode_backward=case.get("ode_backward", "adjoint"))
        params, _, state, metrics = step(params, opt, state, problem["x"], problem["target"],
                                         e=torch.from_numpy(problem["e"].copy()))
        out[name] = {"metrics": metrics, "grads": dict(zip(_flatten(params), opt.grads)),
                     "state": {k: v.numpy() for k, v in _flatten(state).items()}}
    return out


@pytest.fixture(scope="module")
def one_process(problem):
    """The one-process port step of each case on the whole batch."""
    return one_process_steps(problem, CASES)


def _check_grads(got, want):
    """Per leaf: within rel * its largest + floor * its module's largest."""
    module = lambda k: k.split(".")[0]
    largest = {}
    for k, g in want.items():
        largest[module(k)] = max(largest.get(module(k), 0.0), float(np.abs(g).max()))
    assert sorted(got) == sorted(want)
    for k, g in want.items():
        rel, floor = GRAD_TOL[module(k)]
        tol = rel * float(np.abs(g).max()) + floor * largest[module(k)]
        assert float(np.abs(got[k] - g).max()) <= tol, (k, float(np.abs(got[k] - g).max()), tol)
    assert sum(float(np.abs(g).max()) > 0 for g in want.values()) >= 0.9 * len(want)


def _check_against(ranks, want, what):
    if what == "metrics":
        for r in ranks:
            got = r["metrics"]
            assert got["nfe"] == want["metrics"]["nfe"]
            assert got["nfe_forward"] == want["metrics"]["nfe_forward"]
            for k in ("loss", "cnf_loss", "tnocs_loss", "mean_nll", "tnocs_pos_err",
                      "tnocs_time_err"):
                np.testing.assert_allclose(got[k], want["metrics"][k], rtol=1e-5, err_msg=k)
    elif what == "grads":
        _check_grads(ranks[0]["grads"], want["grads"])
    elif what == "state":
        for k, v in want["state"].items():
            np.testing.assert_allclose(ranks[0]["state"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    else:  # every rank holds the same bits
        for r in ranks[1:]:
            for k in ("params", "state", "grads"):
                for path, v in ranks[0][k].items():
                    assert np.array_equal(r[k][path], v), (k, path)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("what", ["metrics", "grads", "state", "ranks_equal"])
def test_two_ranks_match_one_process_step(two_ranks, one_process, case, what):
    """Two ranks of two rows each against the one-process step of four:
    the continuous adjoint, --ode-backward discrete, and accum_steps=2 (each
    rank's microbatch i its rows of the global microbatch i)."""
    ranks = [r[list(CASES).index(case)] for r in two_ranks["steps"]]
    _check_against(ranks, one_process[case], what)
    if what == "metrics":
        assert ranks[0]["metrics"]["nfe"][1] > 0
        if case != "discrete":  # the adjoint's backward counted
            assert ranks[0]["metrics"]["nfe"][1] > ranks[0]["metrics"]["nfe_forward"][1]


@pytest.mark.parametrize("what", ["metrics", "grads", "ranks_equal", "mesh"])
def test_four_rank_dcn_step_matches_one_process(four_ranks, one_process, what):
    """A (dcn 2, dp 2) mesh of four ranks, one row each."""
    if what == "mesh":
        assert {r["mesh"] for r in four_ranks} == {"4 devices, axes ('dcn', 'dp') (2, 2)"}
    else:
        _check_against(four_ranks, one_process["adjoint"], what)


def jax_mesh_train_step(problem, mesh, shard):
    """The JAX package's train step on ``mesh``, the batch placed by
    ``shard``, SGD with rate 1, the noise a constant of the adjoint as the
    port treats it: (params, state, metrics)."""
    jcfg = JaxConfig(**TRAIN)
    tx = optax.sgd(1.0)
    params = jax.tree_util.tree_map(jnp.asarray, problem["weights"]["params"])
    state = jax.tree_util.tree_map(jnp.asarray, problem["weights"]["state"])
    x, target = shard(mesh, (jnp.asarray(problem["x"]), jnp.asarray(problem["target"])))
    with pytest.MonkeyPatch.context() as mp:
        _stop_gradient_noise(mp)
        step = jloop.make_train_step(JaxModel(jcfg), tx, CNF_W, TNOCS_W)
        p, _, s, metrics = step(jax_replicate(mesh, params), jax_replicate(mesh, tx.init(params)),
                                jax_replicate(mesh, state), x, target, problem["key"])
    return p, s, jax.tree_util.tree_map(np.asarray, metrics)


@pytest.fixture(scope="module")
def jax_mesh_step(jax_problem):
    """The JAX package's train step on a 2-device make_mesh (as
    tests/test_parallel.py builds it)."""
    return jax_mesh_train_step(jax_problem, jax_make_mesh(jax.devices()[:2]), jax_shard_batch)


def check_against_jax_step(problem, rank0, jax_step, what):
    """A rank's step (``checks.ranks``'s result) against the JAX package's
    mesh step: tests/test_torch_port_train_step.py's bars."""
    jparams, jstate, jmetrics = jax_step
    template, _ = params_from_jax(problem["weights"]["params"], problem["weights"]["state"],
                                  problem["cfg"], device="cpu")
    params = _merge(template, rank0["params"])
    run = dict(metrics=rank0["metrics"], jmetrics=jmetrics, jparams=jparams, params=params,
               old=[np.asarray(v) for v in jax.tree_util.tree_leaves(problem["weights"]["params"])])
    if what == "metrics":
        _check_metrics(run)
    elif what == "params":
        _check_params(run)
    else:
        want = {"point_cnf." + k: np.asarray(v) for k, v in _flatten(
            jax.tree_util.tree_map(np.asarray, jstate["point_cnf"])).items()}
        for k, v in want.items():
            np.testing.assert_allclose(rank0["state"][k], v, rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("what", ["metrics", "params", "state"])
def test_two_ranks_match_jax_mesh_step(two_ranks, jax_problem, jax_mesh_step, what):
    """The hold against the reference: the same weights, the JAX step's own
    noise fed to the ranks' rows through e=."""
    check_against_jax_step(jax_problem, two_ranks["steps"][0][len(CASES)], jax_mesh_step, what)


def test_collectives_counted(two_ranks):
    """Each kind the adjoint step reduces with, on both ranks alike: one
    gradient buffer of every parameter, one scalar gather, one row gather
    per MovingBatchNorm layer, the request times, the error norms and the
    adjoint's VJP of the replicated leaves."""
    steps = [r[0] for r in two_ranks["steps"]]
    counts = steps[0]["collectives"]
    assert counts == steps[1]["collectives"]
    assert counts["grad"]["calls"] == 1
    assert counts["grad"]["bytes"] == 4 * sum(v.size for v in steps[0]["params"].values())
    assert counts["metrics"]["calls"] == 1 and counts["times"]["calls"] == 1
    assert counts["mbn"]["calls"] == 2
    assert counts["norm"]["calls"] > 10 and counts["adjoint_vjp"]["calls"] > 10
    assert "adjoint_vjp" not in [r[1] for r in two_ranks["steps"]][0]["collectives"]


def one_process_eval_logs(problem, tree, out, pose_out=None):
    """Shape reconstruction and T-NOCS regression in one process over the
    tree's test split in batches of EVAL_BATCH, writing their logs to
    ``out``, then with ``pose_out`` the pose protocol with its scenes
    (without matplotlib, as the ranks run it) there.  Returns T-NOCS's
    two means."""
    cfg = problem["cfg"]
    model = CaSPRModel(cfg, device="cpu")
    params, state = params_from_jax(problem["weights"]["params"], problem["weights"]["state"],
                                    cfg, device="cpu")
    ds = DynamicPCLDataset(tree, split="test", num_pts=ev.PROTOCOL_NUM_PTS,
                           seq_len=ev.PROTOCOL_NUM_STEPS, random_point_sample=False)
    loader = SequenceLoader(ds, EVAL_BATCH, seed=0, pad_last=True)
    ev.test_shape_recon(model, params, state, loader, os.path.join(out, "recon_log.txt"),
                        ev.SPLIT_OBSERVED_STEPS, ev.SPLIT_UNOBSERVED_STEPS,
                        generator=torch.Generator().manual_seed(0),
                        base_samples=_base_samples(EVAL_BATCHES))
    means = ev.test_tnocs_regression(model, params, state, loader,
                                     os.path.join(out, "tnocs_log.txt"))
    if pose_out is not None:
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(sys.modules, "matplotlib", None)
            ev.test_observed_camera_pose_ransac(model, params, state, loader,
                                                os.path.join(pose_out, "pose_log.txt"),
                                                show=True)
    return means


def _csv(path):
    with open(path) as f:
        return [line.split(",") for line in f.read().splitlines()]


def check_eval_artifacts(got_dir, want_dir, stem, sequences=TREE_SIZES["test"]):
    """Shape reconstruction's or T-NOCS's ``stem`` .npz, .csv and .txt in
    ``got_dir`` against ``want_dir``'s: the same keys, shapes, rows (one a
    sequence, two for reconstruction) and lines, the values within 1e-5."""
    got_stem, want_stem = os.path.join(got_dir, stem), os.path.join(want_dir, stem)
    got, want = np.load(got_stem + ".npz"), np.load(want_stem + ".npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    rows, want_rows = _csv(got_stem + ".csv"), _csv(want_stem + ".csv")
    ids = 3 if stem == "recon_log" else 2
    assert [r[:ids] for r in rows] == [r[:ids] for r in want_rows]
    assert len(rows) == (2 if stem == "recon_log" else 1) * sequences + 1
    _check_csv_values(rows, want_rows, ids)
    _check_log(got_stem + ".txt", want_stem + ".txt")


def _check_csv_values(rows, want_rows, ids, tol=1e-5):
    np.testing.assert_allclose(np.array([r[ids:] for r in rows[1:]], float),
                               np.array([r[ids:] for r in want_rows[1:]], float), rtol=tol,
                               atol=tol)


def _check_log(got_path, want_path, tol=1e-5):
    """The same lines, their statistics within ``tol`` (the inference time
    is a clock's)."""
    text, want_text = open(got_path).read(), open(want_path).read()
    number = r"-?\d+\.\d+"
    assert re.sub(number, "#", text) == re.sub(number, "#", want_text)
    stats = lambda s: np.array(re.findall(number, re.sub(r".*Inference time.*", "", s)), float)
    np.testing.assert_allclose(stats(text), stats(want_text), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def one_process_cli(tree, tmp_path_factory):
    """The train CLI in one process: TRAIN_ARGV at TINY over the tree, on
    PyTorch's default thread count.  On one thread its first logged decoder
    NFE is 42 where the ranks and the default give 36: one more rejected
    step (6 evaluations), an accept decision within rounding of its
    threshold."""
    out = str(tmp_path_factory.mktemp("cli_one"))
    with pytest.MonkeyPatch.context() as mp, torch_threads(DEFAULT_THREADS):
        from_flags = config.caspr_config_from_flags
        mp.setattr(cli_train, "caspr_config_from_flags",
                   lambda flags: dataclasses.replace(from_flags(flags), **TINY))
        cli_train.main(["--data-cfg", tree, "--out", out, *TRAIN_ARGV], device="cpu")
    return out


def check_train_cli(out, one_out, results, what, mesh):
    """The train CLI's run on R ranks (``results``: each rank's "cli"
    result) against the one-process run in ``one_out``: rank 0 writes the
    checkpoints, the curve and train_log.txt, rank i > 0 only
    rank<i>_train_log.txt; the checkpoint's parameters (moved by their
    gradient: Adam at beta 0 and lr = eps = 1e10) within the gradient
    bars; the logged losses within 1e-5 and NFE equal on every rank; the
    log names the mesh (``describe``'s ``mesh``)."""
    others = [f"rank{i}_train_log.txt" for i in range(1, len(results))]
    if what == "files":
        names = sorted(os.listdir(out))
        assert names == sorted(os.listdir(one_out) + others)
        assert "time_model_0.pkl" in names and "BEST_time_model.pkl" in names
        assert all(r["collectives"]["grad"]["calls"] == 1 for r in results)
    elif what == "checkpoint":
        cfg = CaSPRConfig(**TINY, radii_list=tuple(float(r) for r in RADII))
        init, _ = caspr_init(torch.Generator().manual_seed(0), cfg, device="cpu")
        start = {k: v.numpy() for k, v in _flatten(init).items()}
        params_of = lambda run: _flatten(
            load_checkpoint(os.path.join(run, "time_model_0.pkl"))["params"])
        got, want = params_of(out), params_of(one_out)
        grads = lambda ck: {k: start[k] - np.asarray(v, np.float32) for k, v in ck.items()}
        _check_grads(grads(got), grads(want))
    else:
        text = open(os.path.join(out, "train_log.txt")).read()
        assert f"Parallel mesh over {mesh}, rank 0" in text
        want = open(os.path.join(one_out, "train_log.txt")).read()
        pick = lambda s, tag: [float(v) for v in re.findall(tag + r" Mean loss: (\S+)", s)]
        nfe = r"Mean NFE \(latent-ode, decoder\): \((\S+), (\S+)\)"
        for tag in ("TRAIN", "VAL"):
            np.testing.assert_allclose(pick(text, tag), pick(want, tag), rtol=1e-5)
        assert re.findall(nfe, text) == re.findall(nfe, want)
        for i, name in enumerate(others, 1):
            other = open(os.path.join(out, name)).read()
            assert f"rank {i}" in other and "BEST" not in other
            for tag in ("TRAIN", "VAL"):
                assert pick(text, tag) and pick(other, tag) == pick(text, tag)
            assert re.findall(nfe, other) == re.findall(nfe, text)


@pytest.fixture
def group_of_one(monkeypatch):
    """This process as a group of one (no torchrun environment)."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    device = parallel.init_distributed(device="cpu")
    try:
        yield device
    finally:
        dist.destroy_process_group()


def test_make_mesh_in_a_group_of_one(group_of_one, monkeypatch):
    assert group_of_one == torch.device("cpu") and dist.get_backend() == "gloo"
    mesh = parallel.make_mesh()
    assert mesh.mesh_dim_names == (parallel.DP_AXIS,) and tuple(mesh.mesh.shape) == (1,)
    mesh2 = parallel.make_mesh(num_slices=1)
    assert tuple(mesh2.mesh.shape) == (1,)
    with pytest.raises(ValueError, match="do not divide"):
        parallel.make_mesh(num_slices=2)
    with pytest.raises(ValueError, match="per-node rank count 1 is not divisible by sp_size=2"):
        parallel.make_mesh(sp_size=2)
    with pytest.raises(ValueError, match="runs gloo"):
        parallel.init_distributed(backend="nccl", device="cpu")
    # a group of one: the shard is the batch, and replicate keeps the values
    batch = {"x": np.arange(12.0).reshape(4, 3), "t": torch.arange(4.0), "s": np.float32(2)}
    shard = parallel.shard_batch(mesh, batch)
    assert np.array_equal(shard["x"], batch["x"]) and torch.equal(shard["t"], batch["t"])
    placed = parallel.global_batch_points(mesh, {"x": batch["x"]}, device="cpu")
    assert placed["x"].device.type == "cpu" and np.array_equal(placed["x"].numpy(), batch["x"])
    # on a gloo mesh too, the rows go to this rank's card unless the CPU is named
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parallel.global_batch_points(mesh, {"x": batch["x"]})
    tree = {"a": torch.ones(3), "b": [torch.zeros(2, 2)]}
    parallel.reset_collectives()
    parallel.replicate(mesh, tree)
    assert torch.equal(tree["a"], torch.ones(3))
    assert parallel.collectives["replicate"] == {"calls": 1, "bytes": 28}


def test_a_rank_without_a_card_raises(monkeypatch):
    """The card is the default device: no CUDA, or no card of index
    LOCAL_RANK, raises before any group is formed; nothing falls back to
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parallel.init_distributed()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 has no card"):
        parallel.init_distributed()
    assert not dist.is_initialized()


def test_shard_rows_follow_the_microbatches():
    """shard_batch's and SequenceLoader's rows of each rank: at one
    microbatch the rank's contiguous part; with microbatches, its part of
    each global microbatch in turn."""
    from caspr_tpu_torch.parallel.mesh import _rows

    x = np.arange(8)
    assert [_rows(x, r, 2, 1).tolist() for r in range(2)] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert [_rows(x, r, 2, 2).tolist() for r in range(2)] == [[0, 1, 4, 5], [2, 3, 6, 7]]
    assert [_rows(torch.arange(8), r, 4, 2).tolist() for r in range(4)] == [
        [0, 4], [1, 5], [2, 6], [3, 7]]
    with pytest.raises(ValueError, match="not divisible"):
        _rows(x, 0, 3, 1)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_loader_shards_follow_the_microbatches(tree, microbatches):
    """Two shards of a shuffled train loader: together each global batch,
    each shard's rows those of shard_batch (so microbatch i of a shard is its
    part of the one-process microbatch i), the items' subsampling the
    unsharded loader's, bit for bit."""
    from caspr_tpu_torch.parallel.mesh import _rows

    ds = DynamicPCLDataset(tree, split="train", num_pts=64, seq_len=3, random_point_sample=True)
    whole = list(SequenceLoader(ds, 4, shuffle=True, drop_last=True, seed=3))
    shards = [list(SequenceLoader(ds, 4, shuffle=True, drop_last=True, seed=3, num_shards=2,
                                  shard_index=r, microbatches=microbatches)) for r in range(2)]
    for bi, batch in enumerate(whole):
        for r in range(2):
            for k in ("input", "target"):
                assert np.array_equal(shards[r][bi][k], _rows(batch[k], r, 2, microbatches))
            assert shards[r][bi]["seq_id"] == list(_rows(np.array(batch["seq_id"]), r, 2,
                                                         microbatches))
    with pytest.raises(ValueError, match="microbatches"):
        SequenceLoader(ds, 4, drop_last=True, num_shards=2, microbatches=4)


@pytest.mark.parametrize("cli, argv, error, match", [
    ("train", ["--multihost"], ValueError, "--multihost requires --parallel"),
    ("train", ["--parallel", "--sp-size", "2"], ValueError,
     "--sp-size 2 does not divide the 1 ranks of a node"),
    ("test", ["--parallel", "--sp-size", "2"], ValueError,
     "--sp-size 2 does not divide the 1 ranks of a node"),
])
def test_flag_checks(cli, argv, error, match, tmp_path):
    """Refused before any process group is formed: sp 2 in a group of one
    (tests/test_torch_port_sp.py refuses the points and batches a mesh does
    not divide)."""
    main = {"train": cli_train.main, "test": cli_test.main}[cli]
    with pytest.raises(error, match=re.escape(match)):
        main(["--data-cfg", "x.cfg", "--out", str(tmp_path)] + argv, device="cpu")
    assert not dist.is_initialized()
