"""The port's command lines (caspr_tpu_torch/cli) against the JAX package's,
on the CPU, at the TINY configuration of tests/test_torch_port_model.py.

- Flag surface: each option group's actions equal the JAX package's (option
  strings, dest, default, type, nargs, choices, action), and
  ``caspr_config_from_flags`` fills the same fields, at the default flags and
  at a non-default set.
- The test CLI runs ``main([...], device="cpu")`` with the port CLI's
  ``caspr_config_from_flags`` patched to TINY, over a synthetic tree of
  10 x 2048 frames (``write_synthetic_tree``: 3 test sequences, one of short
  frames, beside a filtered and a skipped one) with the weights of a JAX
  ``caspr_init`` checkpoint.  Its T-NOCS regression artifacts match the JAX
  package's ``test_tnocs_regression`` on the JAX loader within atol 1e-5
  (the bar of tests/test_torch_port_eval.py), also with --pretrain-tnocs
  (the encoder alone, world times); its shape-reconstruction
  artifacts have the JAX protocol's keys, CSV header and row counts; the
  padded last batch (batch 2, so 1 padded row) is masked: three sequences
  in every artifact.  The radii are widened by ``--radii`` so that the
  encoder's balls hold distinct points (a ball of copies of one point
  magnifies rounding up to 316x in GroupNorm, tests/test_torch_port_model.py).
- The train CLI: a JAX-written checkpoint with an optax state resumes
  (with --ode-backward discrete and --grad-accum 2) with Adam's moments
  restored (one update from them equals optax's, 1e-6); and in
  tests/test_torch_port_cli_train.py (with this file's fixtures, on a
  worker of its own under ``--dist loadfile``) two epochs whose every
  checkpoint loads in the JAX package's load_checkpoint and load_weights
  with every key found, BEST written after validation, and the refusal of
  the flags a run cannot shard.
"""

import argparse
import dataclasses
import functools
import os
import re

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from caspr_tpu.data import DynamicPCLDataset as JaxDataset
from caspr_tpu.data import SequenceLoader as JaxLoader
from caspr_tpu.models.caspr import CaSPRConfig as JaxConfig
from caspr_tpu.models.caspr import CaSPRModel as JaxModel
from caspr_tpu.models.caspr import caspr_init as jax_caspr_init
from caspr_tpu.train import checkpoint as jcheckpoint
from caspr_tpu.train import loop as jloop
from caspr_tpu.utils import config as jconfig
from caspr_tpu.utils import evaluations as jev
from caspr_tpu_torch.cli import test as cli_test
from caspr_tpu_torch.cli import train as cli_train
from caspr_tpu_torch.data import write_synthetic_tree
from caspr_tpu_torch.models.caspr import CaSPRConfig, caspr_init
from caspr_tpu_torch.train import checkpoint, make_optimizer
from caspr_tpu_torch.utils import config
from test_torch_port_model import TINY

SIZES = {"train": 4, "val": 2, "test": 3}
RADII = ["0.08", "0.12", "0.18", "0.25", "0.4", "0.8"]
GROUPS = {"general": "get_general_options", "train": "get_train_options",
          "test": "get_test_options"}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_synthetic_tree(str(tmp_path_factory.mktemp("tree")), seed=7, num_pts=2048,
                                split_sizes=SIZES)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX caspr_init checkpoint at TINY with an optax state one update in."""
    params, state = jax.jit(functools.partial(jax_caspr_init, cfg=JaxConfig(**TINY)))(
        jax.random.PRNGKey(5))
    tx = jloop.make_optimizer(1e-3)
    grads = jax.tree_util.tree_map(
        lambda p: np.cos(np.arange(p.size, dtype=np.float32)).reshape(p.shape), params)
    opt_state = jax.jit(lambda p, g: tx.update(g, tx.init(p), p)[1])(params, grads)
    path = str(tmp_path_factory.mktemp("ckpt") / "jax_init.pkl")
    jcheckpoint.save_checkpoint(path, params, state, opt_state, epoch=4)
    return path, params, state, opt_state


@pytest.fixture
def tiny(monkeypatch):
    """The CLIs build TINY models (with the flags' radii)."""
    def from_flags(flags):
        return dataclasses.replace(config.caspr_config_from_flags(flags), **TINY)
    for module in (cli_test, cli_train):
        monkeypatch.setattr(module, "caspr_config_from_flags", from_flags)


def _actions(group):
    parser = argparse.ArgumentParser()
    group(parser)
    return [(a.option_strings, a.dest, a.default, a.type, a.nargs, a.choices, a.required,
             type(a).__name__) for a in parser._actions], parser._defaults


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_flag_surface_matches_jax(group):
    assert _actions(getattr(config, GROUPS[group])) == _actions(getattr(jconfig, GROUPS[group]))


@pytest.mark.parametrize("argv", [
    [],
    ["--radii", "0.1", "0.3", "--local-feat-size", "64", "--cnf-blocks", "2",
     "--latent-feat-size", "160", "--ode-hidden-size", "32", "--motion-feat-size", "16",
     "--pretrain-tnocs", "--no-augment-quad", "--no-augment-pairs", "--no-regress-tnocs"],
])
def test_config_from_flags_matches_jax(argv):
    def parse(module):
        parser = argparse.ArgumentParser(allow_abbrev=False)
        module.get_general_options(parser)
        return parser.parse_args(["--data-cfg", "x.cfg"] + argv)

    got = dataclasses.asdict(config.caspr_config_from_flags(parse(config)))
    want = dataclasses.asdict(jconfig.caspr_config_from_flags(parse(jconfig)))
    shared = got.keys() & want.keys()
    assert len(shared) >= 16
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}


def test_runtime_flags_write_no_environment(monkeypatch):
    monkeypatch.delenv("CASPR_TPU_ODE_BWD", raising=False)
    before = dict(os.environ)
    for backward in ("adjoint", "discrete"):
        flags = cli_train.parse_args(["--data-cfg", "x.cfg", "--matmul-precision", "highest",
                                      "--ode-backward", backward])
        config.apply_runtime_flags(flags)
        assert dict(os.environ) == before
        assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    monkeypatch.setenv("CASPR_TPU_ODE_STEPS", "9")
    assert config.ode_steps_from_env() == 9
    monkeypatch.setenv("CASPR_TPU_ODE_STEPS", "x")
    assert config.ode_steps_from_env() == 128


@pytest.mark.parametrize("cli", ["train", "test"])
def test_cli_without_cuda_raises(cli, tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"train": cli_train.main, "test": cli_test.main}[cli]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--data-cfg", tree, "--out", str(tmp_path)])


def _csv(path):
    with open(path) as f:
        return [line.split(",") for line in f.read().splitlines()]


def _test_argv(tree, ckpt, out, *protocols):
    return ["--data-cfg", tree, "--weights", ckpt, "--out", out, "--seq-len", "10",
            "--num-pts", "2048", "--batch-size", "2", "--radii", *RADII, *protocols]


@pytest.mark.parametrize("pretrain", [False, True])
def test_test_cli_tnocs_matches_jax(tree, jax_ckpt, tiny, tmp_path, pretrain):
    """With --pretrain-tnocs the CLI loads the encoder alone and the clouds
    keep their world times (no shift to zero)."""
    path, params, state, _ = jax_ckpt
    out = str(tmp_path / "port")
    extra = ["--pretrain-tnocs"] if pretrain else ["--eval-test"]
    cli_test.main(_test_argv(tree, path, out, "--eval-tnocs-regression", *extra), device="cpu")
    jcfg = JaxConfig(**TINY, radii_list=tuple(float(r) for r in RADII), pretrain_tnocs=pretrain)
    if pretrain:
        params, state = {"encoder": params["encoder"]}, {}
    jds = JaxDataset(tree, split="test", num_pts=2048, seq_len=10, shift_time_to_zero=not pretrain,
                     random_point_sample=False)
    jlog = str(tmp_path / "jax_log.txt")
    jev.test_tnocs_regression(JaxModel(jcfg), params, state,
                              JaxLoader(jds, 2, seed=0, pad_last=True), jlog)
    got, want = np.load(os.path.join(out, "test_log.npz")), np.load(jlog[:-3] + "npz")
    assert sorted(got.files) == sorted(want.files) == ["space", "time"]
    for k in want.files:
        assert got[k].shape == want[k].shape == (SIZES["test"] * 10,)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    rows, jrows = _csv(os.path.join(out, "test_log.csv")), _csv(jlog[:-3] + "csv")
    assert rows[0] == jrows[0] and len(rows) == len(jrows) == SIZES["test"] + 1
    assert [r[:2] for r in rows] == [r[:2] for r in jrows]
    log = open(os.path.join(out, "test_log.txt")).read()
    if pretrain:
        assert "Loading pre-trained canonicalizer from" in log
    else:
        loss = re.search(r"Batch 0/0\] TEST Mean loss: (\S+)", log)
        assert loss and np.isfinite(float(loss.group(1)))
        assert "Loading model weights from" in log
    assert re.search(r"TIMING eval-tnocs-regression: \S+ s, loader wait \S+ s per batch over 2 "
                     r"batches", log)


def test_test_cli_shape_recon_artifacts(tree, jax_ckpt, tiny, tmp_path):
    """The split protocol (observed 0, 5, 9): the JAX protocol's npz keys,
    CSV header and row counts, over the three real sequences."""
    path, params, state, _ = jax_ckpt
    out = str(tmp_path / "port")
    cli_test.main(_test_argv(tree, path, out, "--eval-shape-recon-unobserved"), device="cpu")
    jds = JaxDataset(tree, split="test", num_pts=2048, seq_len=10, shift_time_to_zero=True,
                     random_point_sample=False)
    jlog = str(tmp_path / "jax_log.txt")
    jcfg = JaxConfig(**TINY, radii_list=tuple(float(r) for r in RADII))
    jev.test_shape_recon(JaxModel(jcfg), params, state, JaxLoader(jds, 2, seed=0, pad_last=True),
                         jlog, jev.SPLIT_OBSERVED_STEPS, jev.SPLIT_UNOBSERVED_STEPS,
                         key=jax.random.PRNGKey(0))
    got, want = np.load(os.path.join(out, "test_log.npz")), np.load(jlog[:-3] + "npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].shape == want[k].shape and np.all(np.isfinite(got[k])), k
    assert got["observed_chamfer"].shape == (SIZES["test"] * 3,)
    assert got["unobserved_emd"].shape == (SIZES["test"] * 7,)
    rows, jrows = _csv(os.path.join(out, "test_log.csv")), _csv(jlog[:-3] + "csv")
    assert rows[0] == jrows[0] == ["type", "model_id", "seq_id", "chamfer", "emd"]
    assert [r[:3] for r in rows] == [r[:3] for r in jrows]
    assert len(rows) == 2 * SIZES["test"] + 1
    assert sorted({r[1] for r in rows[1:]}) == [f"test_{i:04d}" for i in range(SIZES["test"])]


def test_jax_checkpoint_resumes_with_adam_moments(tree, jax_ckpt, tiny, tmp_path):
    path, params, state, opt_state = jax_ckpt
    out = str(tmp_path / "resume")
    cli_train.main(["--data-cfg", tree, "--out", out, "--seq-len", "3", "--num-pts", "64",
                    "--batch-size", "2", "--epochs", "1", "--weights", path, "--radii", *RADII,
                    "--ode-backward", "discrete", "--grad-accum", "2"], device="cpu")
    log = open(os.path.join(out, "train_log.txt")).read()
    assert "Restored optimizer state from checkpoint" in log
    assert "CASPR_TPU_ODE_BWD" not in os.environ
    assert np.all(np.isfinite([float(v) for v in re.findall(r"TRAIN Mean loss: (\S+)", log)]))

    # the moments themselves: one update from the restored state is optax's
    ck = checkpoint.load_checkpoint(path)
    cfg = CaSPRConfig(**TINY)
    fresh, _ = caspr_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    port_params = checkpoint.load_weights(fresh, ck["params"])
    opt = make_optimizer(1e-3).init(port_params)
    checkpoint.restore_adam_state(port_params, opt, ck["opt_state"])
    paths = list(checkpoint._flatten(port_params))
    grads = {k: np.sin(np.arange(v.numel(), dtype=np.float32)).reshape(tuple(v.shape))
             for k, v in checkpoint._flatten(port_params).items()}
    for k, leaf in checkpoint._flatten(port_params).items():
        leaf.grad = torch.from_numpy(grads[k])
    opt.step()
    tx = jloop.make_optimizer(1e-3)
    jgrads = jax.tree_util.tree_map(lambda p: np.array(p), params)
    flat_j = jcheckpoint._flatten(jgrads)
    for k in flat_j:
        flat_j[k][...] = grads[k]
    updates, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, jgrads), opt_state, params)
    want = jcheckpoint._flatten(jax.tree_util.tree_map(np.asarray,
                                                       optax.apply_updates(params, updates)))
    got = checkpoint._flatten(port_params)
    assert sorted(paths) == sorted(want)
    for k in paths:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)

    # a state that does not fit raises, and the CLI starts Adam fresh
    bad = dict(ck["opt_state"], mu={"encoder": {}})
    with pytest.raises(ValueError):
        checkpoint.restore_adam_state(port_params, make_optimizer(1e-3).init(port_params), bad)
    bad_path = str(tmp_path / "bad_opt.pkl")
    checkpoint.save_checkpoint(bad_path, port_params, ck["state"], bad)
    cli_train.main(["--data-cfg", tree, "--out", str(tmp_path / "fresh"), "--epochs", "0",
                    "--weights", bad_path, "--radii", *RADII], device="cpu")
    log = open(str(tmp_path / "fresh" / "train_log.txt")).read()
    assert "incompatible" in log and "starting Adam fresh" in log
