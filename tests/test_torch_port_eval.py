"""The port's evaluation protocols against the JAX package's on the CPU,
with a TINY model, the same weights on both sides, and one protocol-shaped
synthetic batch (B = 1, T = 10, N = 2048) from a loader in the form of
tests/test_evaluations.py.

The JAX reconstruction eval draws its base samples as
``normal(split(split(key)[1])[0], (B*T, 2048, 3))`` (evaluations.py:132,
caspr.py:246, 263); the test computes that array and injects it into the
port through ``base_samples=``.

Tolerances:
  - shape reconstruction ``.npz`` arrays: 1e-4 relative for the Chamfer
    values (decoded points agree to ~1e-5; the distances are O(0.1)), and
    5e-4 relative for the EMD values: float32 approxmatch moves by a few
    1e-4 with the last bits of its input (tests/test_torch_port_metrics.py);
  - T-NOCS regression ``.npz`` arrays: 1e-5 abs;
  - pose: the same RANSAC source with the same seeds on encodings that
    agree to 1e-4; RANSAC amplifies, so only the means are held, to 1e-2;
    its pose scenes (show=True) hold the same files and vertex counts, and
    the ground truth's rows (clouds, NOCS, cameras) byte for byte;
  - CSV headers, row counts and row order equal; the logs hold the same
    lines, numbers aside.
"""

import csv
import functools
import os
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from caspr_tpu.models.caspr import CaSPRConfig as JaxConfig
from caspr_tpu.models.caspr import CaSPRModel as JaxModel
from caspr_tpu.models.caspr import caspr_init
from caspr_tpu.utils import evaluations as jev
from caspr_tpu.viz import export as jexport
from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
from caspr_tpu_torch.utils import evaluations as ev
from caspr_tpu_torch.utils import ransac
from caspr_tpu_torch.viz.export import NO_ANIMATION
from caspr_tpu_torch.weights import (
    load_encoder_weights_from_full,
    load_weights,
    params_from_jax,
)
from test_torch_port_model import TINY, _numpy_weights

T, N = ev.PROTOCOL_NUM_STEPS, ev.PROTOCOL_NUM_PTS


class _FakeLoader:
    """One protocol-shaped batch of two rows of which one is real (the
    second repeats the first, as the loader's padding does)."""

    def __init__(self, with_pose=False, steps=T, pose=None):
        rng = np.random.RandomState(0)
        t = np.linspace(0, 1, T, dtype=np.float32)
        nocs = rng.rand(1, T, N, 4).astype(np.float32)
        nocs[..., 3] = t[None, :, None]
        world = nocs.copy()
        world[..., 3] = t[None, :, None] * 5.0
        pad = lambda a: np.concatenate([a, a], axis=0)[:, :steps]
        self.batch = {"input": pad(world), "target": pad(nocs), "model_id": ["m0", "m0"],
                      "seq_id": ["s0", "s0"], "valid": 1}
        if with_pose:
            self.batch["pose"] = np.tile(np.eye(4, dtype=np.float32) if pose is None else pose,
                                         (2, T, 1, 1))

        class _DS:
            def set_return_pose_data(self, flag):
                pass

        self.dataset = _DS()

    def __iter__(self):
        return iter([self.batch])

    def __len__(self):
        return 1


@pytest.fixture(scope="module")
def both():
    jcfg = JaxConfig(**TINY)
    shapes = jax.eval_shape(functools.partial(caspr_init, cfg=jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params_np = _numpy_weights(shapes[0], rng)
    state_np = _numpy_weights(shapes[1], rng, "/point_cnf")
    as_j = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    cfg = CaSPRConfig(**TINY)
    params, state = params_from_jax(params_np, state_np, cfg, device="cpu")
    return dict(jax=(JaxModel(jcfg), as_j(params_np), as_j(state_np)),
                port=(CaSPRModel(cfg, device="cpu"), params, state),
                params_np=params_np)


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _log_shape(path):
    """The log with every number replaced, and the wall-clock line dropped."""
    lines = [l for l in open(path).read().splitlines() if "Inference time" not in l]
    return re.sub(r"-?\d+\.\d+(e-?\d+)?|nan", "#", "\n".join(lines))


def test_shape_recon_matches(both, tmp_path):
    jlog, plog = os.path.join(tmp_path, "jax_log.txt"), os.path.join(tmp_path, "port_log.txt")
    key = jax.random.PRNGKey(1)
    jev.test_shape_recon(*both["jax"], _FakeLoader(), jlog, jev.SPLIT_OBSERVED_STEPS,
                         jev.SPLIT_UNOBSERVED_STEPS, key=key)
    k_samp = jax.random.split(jax.random.split(key)[1])[0]
    base = np.array(jax.random.normal(k_samp, (2 * T, N, 3), jnp.float32)).reshape(2, T, N, 3)
    ev.test_shape_recon(*both["port"], _FakeLoader(), plog, ev.SPLIT_OBSERVED_STEPS,
                        ev.SPLIT_UNOBSERVED_STEPS, base_samples=[base])
    want, got = np.load(jlog[:-3] + "npz"), np.load(plog[:-3] + "npz")
    assert sorted(got.files) == sorted(want.files)
    assert len(got["observed_chamfer"]) == 3 and len(got["unobserved_emd"]) == 7  # real row only
    for k in got.files:
        rtol = 5e-4 if k.endswith("emd") else 1e-4
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=0, err_msg=k)
    jrows, prows = _rows(jlog[:-3] + "csv"), _rows(plog[:-3] + "csv")
    assert prows[0] == jrows[0] == ["type", "model_id", "seq_id", "chamfer", "emd"]
    assert [r[:3] for r in prows] == [r[:3] for r in jrows] and len(prows) == 1 + 2
    assert _log_shape(plog) == _log_shape(jlog)
    assert "UNOBSERVED SAMPLING RECONSTR EVAL" in open(plog).read()


def test_shape_recon_draws_from_the_generator(both, tmp_path):
    """Without injected samples the base points come from the generator;
    all-observed protocol: no unobserved block in the artifacts."""
    out = {}
    for name, seed in (("a", 5), ("c", 6)):
        log_out = os.path.join(tmp_path, f"{name}_log.txt")
        ev.test_shape_recon(*both["port"], _FakeLoader(), log_out, ev.ALL_OBSERVED_STEPS,
                            ev.ALL_UNOBSERVED_STEPS, generator=torch.Generator().manual_seed(seed))
        out[name] = np.load(log_out[:-3] + "npz")
    assert len(out["a"]["observed_chamfer"]) == T and len(out["a"]["unobserved_chamfer"]) == 0
    assert np.all(np.isfinite(out["a"]["observed_emd"]))
    assert not np.array_equal(out["a"]["observed_emd"], out["c"]["observed_emd"])
    assert "UNOBSERVED" not in open(os.path.join(tmp_path, "a_log.txt")).read().replace(
        "Unobserved steps", "")


def test_tnocs_regression_matches(both, tmp_path):
    jlog, plog = os.path.join(tmp_path, "jax_log.txt"), os.path.join(tmp_path, "port_log.txt")
    want_means = jev.test_tnocs_regression(*both["jax"], _FakeLoader(), jlog)
    got_means = ev.test_tnocs_regression(*both["port"], _FakeLoader(), plog)
    np.testing.assert_allclose(got_means, want_means, rtol=0, atol=1e-5)
    want, got = np.load(jlog[:-3] + "npz"), np.load(plog[:-3] + "npz")
    assert sorted(got.files) == sorted(want.files) == ["space", "time"]
    for k in got.files:
        assert len(got[k]) == T
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    jrows, prows = _rows(jlog[:-3] + "csv"), _rows(plog[:-3] + "csv")
    assert prows[0] == jrows[0] and [r[:2] for r in prows] == [r[:2] for r in jrows]
    assert len(prows) == 2
    assert _log_shape(plog) == _log_shape(jlog)


def _ply_rows(path):
    with open(path) as f:
        return f.read().split("end_header\n")[1].splitlines()


def test_pose_ransac_matches(both, tmp_path, monkeypatch):
    """With show=True (the JAX package's animation off, and the port
    without matplotlib, as on the card's machine)."""
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
    jlog, plog = str(tmp_path / "jax" / "jax_log.txt"), str(tmp_path / "port" / "port_log.txt")
    angle = 0.4  # a true pose other than the identity: the scene's cameras move
    pose = np.eye(4, dtype=np.float32)
    pose[:2, :2] = [[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]]
    pose[:3, 3] = [0.1, -0.2, 0.3]
    monkeypatch.setattr(jexport, "_export_animation", lambda *args: None)
    jev.test_observed_camera_pose_ransac(*both["jax"], _FakeLoader(with_pose=True, pose=pose),
                                         jlog, show=True)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    ev.test_observed_camera_pose_ransac(*both["port"], _FakeLoader(with_pose=True, pose=pose),
                                        plog, show=True)
    want = np.load(jlog[: -len(".txt")] + "_RANSAC.npz")
    got = np.load(plog[: -len(".txt")] + "_RANSAC.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in got.files:
        assert len(got[k]) == T and np.all(np.isfinite(got[k]))
        rel = 1e-2 * max(1.0, abs(float(np.mean(want[k]))))
        np.testing.assert_allclose(np.mean(got[k]), np.mean(want[k]), rtol=0, atol=rel, err_msg=k)
    jrows = _rows(jlog[: -len(".txt")] + "_RANSAC.csv")
    prows = _rows(plog[: -len(".txt")] + "_RANSAC.csv")
    assert prows[0] == jrows[0] == ["model_id", "seq_id", "pos", "rot", "point"]
    assert len(prows) == len(jrows) == 2
    port_log = _log_shape(plog)
    assert port_log.count(NO_ANIMATION) == 1
    assert port_log.replace(NO_ANIMATION + "\n", "") == _log_shape(jlog)

    # one scene, the padded row's left out: predicted NOCS, the ground
    # truth under the predicted and the true pose, its NOCS, two frusta
    scene = "pose_m0_s0"
    for side in ("jax", "port"):
        assert [d for d in os.listdir(tmp_path / side) if d.startswith("pose_")] == [scene]
    files = sorted(os.listdir(tmp_path / "port" / scene))
    assert files == sorted(os.listdir(tmp_path / "jax" / scene))
    assert files == [f"frame_{i:04d}.ply" for i in range(T)] + ["viewer.html"]
    for name in files[:-1]:
        got, want = (_ply_rows(tmp_path / side / scene / name) for side in ("port", "jax"))
        assert len(got) == len(want) == 4 * N + 2 * 64
        assert got[2 * N:4 * N + 64] == want[2 * N:4 * N + 64], name


def test_ransac_native_and_numpy_recover_a_known_pose():
    rng = np.random.default_rng(1)
    src = rng.random((400, 3))
    angle = 0.7
    rot = np.array([[np.cos(angle), -np.sin(angle), 0], [np.sin(angle), np.cos(angle), 0],
                    [0, 0, 1.0]])
    dst = src @ rot.T + np.array([0.1, -0.2, 0.3])
    dst[:100] = rng.random((100, 3))  # a quarter of the correspondences are outliers
    native = ransac.ransac_rigid_registration(src, dst, seed=3)
    plain = ransac._ransac_numpy(src, dst, 0.015, 4, 50000, 5000, 3)
    for trans in (native, plain):
        np.testing.assert_allclose(trans[:3, :3], rot, atol=2e-2)
        np.testing.assert_allclose(trans[:3, 3], [0.1, -0.2, 0.3], atol=2e-2)


@pytest.mark.parametrize("fn", ["recon", "tnocs", "pose"])
def test_protocol_violation_raises(both, fn, tmp_path):
    log_out = os.path.join(tmp_path, "unused_log.txt")
    loader = _FakeLoader(with_pose=True, steps=5)
    with pytest.raises(ValueError, match="protocol requires"):
        if fn == "recon":
            ev.test_shape_recon(*both["port"], loader, log_out, [0, 2], [1])
        elif fn == "tnocs":
            ev.test_tnocs_regression(*both["port"], loader, log_out)
        else:
            ev.test_observed_camera_pose_ransac(*both["port"], loader, log_out)
    with pytest.raises(ValueError, match="points"):
        ev._check_protocol(T, 1024)


def test_eval_reconstr_frames_math():
    rng = np.random.RandomState(1)
    gt = rng.rand(3, 64, 3).astype(np.float32)
    chamfer, emd = ev.eval_reconstr_frames(gt, gt, device="cpu")
    assert np.all(chamfer < 1e-8) and np.all(emd < 1e-3)
    shifted = gt + np.array([0.2, 0, 0], np.float32)
    want = jev.eval_reconstr_frames(shifted, gt)
    got = ev.eval_reconstr_frames(shifted, gt, device="cpu")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    # 64 points: the float32 matching is more ambiguous still than at 2048
    np.testing.assert_allclose(got[1], want[1], rtol=2e-3)
    assert np.all(got[0] > 1e-4) and np.all(got[1] > 0.1)


def test_partial_weight_loaders(both, capsys):
    """load_weights keeps what the checkpoint lacks and ignores what does
    not fit, with the warnings of the JAX package's loader; the encoder-only
    load touches nothing else."""
    _, params, _ = both["port"]
    zeros = lambda tree: (
        {k: zeros(v) for k, v in tree.items()} if isinstance(tree, dict)
        else [zeros(v) for v in tree] if isinstance(tree, list) else torch.zeros_like(tree))
    loaded = dict(both["params_np"])
    latent = dict(loaded["latent_ode"])
    latent.pop("layer3")
    latent["layer0"] = {"weight": np.zeros((2, 2), np.float32), "bias": latent["layer0"]["bias"]}
    loaded["latent_ode"] = latent
    loaded["extra_head"] = {"weight": np.ones((2, 2), np.float32)}
    merged = load_weights(zeros(params), loaded)
    printed = capsys.readouterr().out
    assert "keys not found in the given checkpoint" in printed and "latent_ode.layer3.weight" in printed
    assert "checkpoint keys not in the current model" in printed and "extra_head.weight" in printed
    assert "latent_ode.layer0.weight" in printed
    assert torch.equal(merged["latent_ode"]["layer1"]["weight"], params["latent_ode"]["layer1"]["weight"])
    assert not merged["latent_ode"]["layer3"]["weight"].any()  # missing: kept (zeros)
    assert not merged["latent_ode"]["layer0"]["weight"].any()  # misshapen: kept
    assert torch.equal(merged["latent_ode"]["layer0"]["bias"], params["latent_ode"]["layer0"]["bias"])
    assert torch.equal(merged["point_cnf"][1]["odenet"]["layers"][0]["_layer"]["weight"],
                       params["point_cnf"][1]["odenet"]["layers"][0]["_layer"]["weight"])
    enc = load_encoder_weights_from_full(zeros(params), both["params_np"])
    flat = lambda t: torch.cat([v.reshape(-1) for v in jax.tree_util.tree_leaves(t)])
    assert torch.equal(flat(enc["encoder"]), flat(params["encoder"]))
    assert not flat(enc["point_cnf"]).any() and not flat(enc["latent_ode"]).any()
    with pytest.raises(KeyError):
        load_encoder_weights_from_full(params, {"latent_ode": {}})
