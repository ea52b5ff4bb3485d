"""The port's train command line (caspr_tpu_torch/cli/train.py) against
the JAX package's checkpoints on the CPU, at the TINY configuration, with
the fixtures of tests/test_torch_port_cli.py (its docstring), on a worker
of its own under ``--dist loadfile``: two epochs whose every checkpoint
loads in the JAX package's load_checkpoint and load_weights with every key
found, BEST written after validation; and both command lines refuse the
flags a run cannot shard.
"""

import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from caspr_tpu.models.caspr import CaSPRConfig as JaxConfig
from caspr_tpu.models.caspr import caspr_init as jax_caspr_init
from caspr_tpu.train import checkpoint as jcheckpoint
from caspr_tpu_torch.cli import test as cli_test
from caspr_tpu_torch.cli import train as cli_train
from caspr_tpu_torch.train import checkpoint
from test_torch_port_cli import RADII
from test_torch_port_cli import tiny, tree  # noqa: F401 (fixtures)
from test_torch_port_model import TINY


@pytest.mark.parametrize("cli, argv, match", [
    ("train", ["--parallel", "--sp-size", "2"], "--sp-size 2 does not divide the 1 ranks"),
    ("train", ["--multihost"], "--multihost requires --parallel"),
    ("train", ["--sp-size", "2"], "--sp-size 2 requires --parallel"),
    ("test", ["--parallel", "--sp-size", "2"], "--sp-size 2 does not divide the 1 ranks"),
    ("test", ["--sp-size", "4"], "--sp-size 4 requires --parallel"),
])
def test_unported_flags_raise(cli, argv, match, tmp_path):
    """The flags a run cannot shard raise ValueError before any process
    group is formed: --sp-size without --parallel, or in a group of one
    (sp needs that many ranks a node); --multihost without --parallel, as
    the JAX package refuses it.  --parallel itself runs
    (tests/test_torch_port_parallel.py), and --sp-size with it
    (tests/test_torch_port_sp.py)."""
    main = {"train": cli_train.main, "test": cli_test.main}[cli]
    with pytest.raises(ValueError, match=re.escape(match)):
        main(["--data-cfg", "x.cfg", "--out", str(tmp_path)] + argv, device="cpu")


def _jax_leaves(tree_):
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(tree_)]


def test_train_cli_checkpoints_cross_to_jax(tree, tiny, tmp_path):
    out = str(tmp_path / "train")
    cli_train.main(["--data-cfg", tree, "--out", out, "--seq-len", "3", "--num-pts", "64",
                    "--batch-size", "2", "--epochs", "2", "--val-every", "1", "--save-every",
                    "1", "--print-every", "1", "--radii", *RADII], device="cpu")
    names = sorted(os.listdir(out))
    for name in ("BEST_time_model.pkl", "time_model_0.pkl", "time_model_1.pkl",
                 "train_curve.npz", "train_log.txt"):
        assert name in names
    log = open(os.path.join(out, "train_log.txt")).read()
    assert log.index("VAL Mean loss") < log.index("BEST Val loss so far! Saving checkpoint...")
    losses = [float(v) for v in re.findall(r"TRAIN Mean loss: (\S+)", log)]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    assert len(re.findall(r"TIMING epoch \d: \S+ s per train step over 2 steps", log)) == 2
    curve = np.load(os.path.join(out, "train_curve.npz"))
    assert curve["train_losses"].shape == (4,) and curve["val_losses"].shape == (2,)

    jshapes = jax.eval_shape(lambda k: jax_caspr_init(k, JaxConfig(**TINY)), jax.random.PRNGKey(0))
    for name in ("BEST_time_model.pkl", "time_model_1.pkl"):
        ck = jcheckpoint.load_checkpoint(os.path.join(out, name))
        target = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), jshapes[0])
        merged = jcheckpoint.load_weights(target, ck["params"])
        port_ck = checkpoint.load_checkpoint(os.path.join(out, name))
        flat = checkpoint._flatten(port_ck["params"])
        assert len(_jax_leaves(merged)) == len(flat)
        got = jcheckpoint._flatten(jax.tree_util.tree_map(np.asarray, merged))
        for k, v in flat.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert int(ck["opt_state"]["count"]) == 4  # two epochs of two steps
