"""The port's reference-checkpoint converter (caspr_tpu_torch/compat) against
the JAX package's (caspr_tpu/compat), on a state dict written with the
reference's key names.

The state dict is built as tests/test_torch_parity.py builds it: weights of
the JAX package's caspr_init at the TINY configuration, renamed by that
file's ``_reference_key_for``, convs unsqueezed to (out, in, 1), under the
DataParallel ``module.`` prefix, the MovingBatchNorm buffers and the
solvers' NFE buffers beside them; it is torch.save'd to a .pth.  Every
converted leaf must equal the JAX converter's bit for bit, and the .pth must
load through the port's load_checkpoint and load_weights with no key left
over.
"""

import numpy as np
import pytest
import torch

import jax

from caspr_tpu.compat import convert_torch_state_dict as jax_convert
from caspr_tpu.models.caspr import CaSPRConfig as JaxConfig
from caspr_tpu.models.caspr import caspr_init as jax_caspr_init
from caspr_tpu_torch.compat import convert_torch_checkpoint, convert_torch_state_dict
from caspr_tpu_torch.models.caspr import CaSPRConfig, caspr_init
from caspr_tpu_torch.train.checkpoint import _flatten, load_checkpoint, load_state, load_weights
from test_torch_parity import _reference_key_for
from test_torch_port_model import TINY


@pytest.fixture(scope="module")
def reference_sd():
    params, state = jax_caspr_init(jax.random.PRNGKey(3), JaxConfig(**TINY))
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    sd = {}
    for ours, val in _flatten(params).items():
        ref_key, is_conv = _reference_key_for(ours)
        v = torch.from_numpy(np.array(val))
        sd["module." + ref_key] = v.unsqueeze(-1) if is_conv else v
    for c, st in enumerate(state["point_cnf"]):
        for name, v in st.items():
            sd[f"module.point_cnf.chain.{c}.{name}"] = torch.from_numpy(np.array(v))
    sd["module.latent_ode.ode_func._num_evals"] = torch.tensor(0.0)
    sd["module.point_cnf.chain.1.odefunc._num_evals"] = torch.tensor(0.0)
    return sd, params, state


def _assert_trees_equal(got, want):
    got, want = _flatten(got), _flatten(want)
    assert got.keys() == want.keys()
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("prefix", ["module.", ""])
def test_converter_matches_jax(reference_sd, prefix):
    sd = {prefix + k[len("module."):]: v for k, v in reference_sd[0].items()}
    got_params, got_state = convert_torch_state_dict(sd)
    want_params, want_state = jax_convert(sd)
    _assert_trees_equal(got_params, want_params)
    _assert_trees_equal(got_state, want_state)
    _assert_trees_equal(got_params, reference_sd[1])


def test_pth_loads_into_the_port(reference_sd, tmp_path, capsys):
    sd, params, state = reference_sd
    for name, payload in (("plain.pth", sd), ("wrapped.pt", {"state_dict": sd})):
        path = str(tmp_path / name)
        torch.save(payload, path)
        _assert_trees_equal(convert_torch_checkpoint(path)[0], jax_convert(sd)[0])
        ck = load_checkpoint(path)
        assert ck["epoch"] == 0
        cfg = CaSPRConfig(**TINY)
        fresh, fresh_state = caspr_init(torch.Generator().manual_seed(0), cfg, device="cpu")
        capsys.readouterr()
        merged = load_weights(fresh, ck["params"])
        assert "WARNING" not in capsys.readouterr().out  # every key found, none left over
        _assert_trees_equal({k: v.numpy() for k, v in _flatten(merged).items()}, _flatten(params))
        merged_state = load_state(fresh_state, ck["state"])
        _assert_trees_equal({k: v.numpy() for k, v in _flatten(merged_state).items()},
                            _flatten(state))


def test_converter_refuses_unknown_layouts():
    with pytest.raises(ValueError):
        convert_torch_state_dict({"encoder.conv1.weight": torch.zeros(4, 3, 2)})
    with pytest.raises(KeyError):
        convert_torch_state_dict({"latent_ode.ode_func.dynamics_net.1.weight": torch.zeros(2)})
