"""The port's visualisation export, viz command line, pose scenes and
profiling helpers against the JAX package, on the CPU.

- Export: ``save_ply``, ``export_html_viewer``, ``export_pcl_seq`` (PLY
  frames, viewer.html, the animation's file name), ``nocs_cube_points``,
  the colour helpers, ``_camera_frustum_points`` and ``_export_pose_scene``
  write the same bytes, or return equal arrays, as the JAX package's for
  the same seeded numpy inputs.  Without matplotlib the export writes the
  PLY frames and the viewer, no animation, and says so in one line.
- The interpolation times are bit for bit ``jnp.linspace(0, 1, S)``.
- The viz option group equals the JAX package's, and the whole viz parser
  gives the same flags.
- Reconstruct at the viz settings (batch 1, shared times, constant base
  samples) at the TINY config of tests/test_torch_port_model.py, with the
  JAX run's Gaussian or contour base samples injected: NFE equal, points
  and log-probabilities within 1e-4 (the bar of that file).
- Both viz command lines over one synthetic tree with the same .pkl
  weights (the JAX model's encode and reconstruct jitted, its animation
  off; the port without matplotlib): the same scenes and files, the same
  vertex counts, the ground-truth, input and cube rows byte-identical,
  the predicted T-NOCS within 1e-5, so within 1e-5 + 1e-6 after parsing
  (each side is printed to 6 decimals, rounded to half a unit).  The
  radii are widened as in tests/test_torch_port_cli.py, and the frames
  hold 2048 points: with fewer, balls of copies of one point magnify the
  encoder's float32 rounding in GroupNorm (4e-5 at 128 points).
- The port's test CLI with ``--show-pose-viz`` writes one pose scene per
  sequence.
"""

import argparse
import dataclasses
import functools
import importlib.util
import json
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
from caspr_tpu.models.caspr import caspr_init as jax_caspr_init
from caspr_tpu.train import checkpoint as jcheckpoint
from caspr_tpu.utils import config as jconfig
from caspr_tpu.utils import evaluations as jev
from caspr_tpu.utils import runtime as jruntime
from caspr_tpu.viz import export as jexport
from caspr_tpu.viz import html_viewer as jhtml
from caspr_tpu_torch.cli import test as cli_test
from caspr_tpu_torch.cli import viz as cli_viz
from caspr_tpu_torch.data import write_synthetic_tree
from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
from caspr_tpu_torch.utils import config, profiling
from caspr_tpu_torch.utils import evaluations as ev
from caspr_tpu_torch.viz import export, html_viewer
from caspr_tpu_torch.weights import params_from_jax
from test_torch_port_cli import RADII, _actions
from test_torch_port_model import TINY, _numpy_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = JaxConfig(**TINY, radii_list=tuple(float(r) for r in RADII))
# the viz runs: batch 1, 3 frames of 2048 points, 64 decoded points, 7 times
T, N, Q, S = 3, 2048, 64, 7
CUBE_ROWS = 2 * 12 * 24
POINT_TOL = 1e-4
# T-NOCS 1e-5 apart, each printed to 6 decimals
PLY_TNOCS_TOL = 1e-5 + 1e-6


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _ply_rows(path):
    """The vertex rows of an ASCII PLY, checked against its header's count."""
    with open(path) as f:
        head, body = f.read().split("end_header\n")
    rows = body.splitlines()
    assert len(rows) == int(re.search(r"element vertex (\d+)", head).group(1))
    return rows


def _coords(rows):
    return np.array([[float(v) for v in r.split()[:3]] for r in rows])


def _viewer_payload(path):
    with open(path) as f:
        line = next(l for l in f if l.startswith("const DATA = "))
    return json.loads(line[len("const DATA = "):].rstrip().rstrip(";"))


def _no_animation_in_jax(monkeypatch):
    monkeypatch.setattr(jexport, "_export_animation", lambda *args: None)


def _tracks(rng, num_tracks, frames, n):
    return [[rng.standard_normal((n, 3)).astype(np.float32) for _ in range(frames)]
            for _ in range(num_tracks)]


# ------------------------------ export ----------------------------------


@pytest.mark.parametrize("dtype, colors", [(np.float32, True), (np.float64, True),
                                           (np.float32, False)])
def test_save_ply_bytes_match_jax(tmp_path, dtype, colors):
    rng = np.random.default_rng(0)
    pts = (rng.standard_normal((64, 3)) * 3).astype(dtype)
    # beyond [0, 1] on both sides (clipped), and 1/255 steps (truncated)
    cols = np.concatenate([rng.random((60, 3)) * 1.4 - 0.2,
                           np.arange(12).reshape(4, 3) / 255.0]) if colors else None
    export.save_ply(str(tmp_path / "port.ply"), pts, cols)
    jexport.save_ply(str(tmp_path / "jax.ply"), pts, cols)
    assert _bytes(tmp_path / "port.ply") == _bytes(tmp_path / "jax.ply")


@pytest.mark.parametrize("with_rgb, names", [(True, None), (False, ["gt", "pred"])])
def test_html_viewer_bytes_match_jax(tmp_path, with_rgb, names):
    rng = np.random.default_rng(1)
    seqs = [_tracks(rng, 1, 3, 20)[0], _tracks(rng, 1, 2, 7)[0]]
    rgbs = [[rng.random((20, 3)) * 1.2 for _ in range(3)], None] if with_rgb else None
    html_viewer.export_html_viewer(str(tmp_path / "p" / "v.html"), seqs, rgbs, fps=4,
                                   track_names=names)
    jhtml.export_html_viewer(str(tmp_path / "j" / "v.html"), seqs, rgbs, fps=4,
                             track_names=names)
    assert _bytes(tmp_path / "p" / "v.html") == _bytes(tmp_path / "j" / "v.html")


def test_export_pcl_seq_matches_jax(tmp_path):
    """Tracks of unequal lengths, one without colours: every file the same,
    the PLY frames and viewer.html byte for byte (matplotlib is present
    here: both write an animation)."""
    rng = np.random.default_rng(2)
    seqs = [_tracks(rng, 1, 3, 12)[0], _tracks(rng, 1, 1, 5)[0]]
    rgbs = [[rng.random((12, 3)) for _ in range(3)], None]
    pdir = export.export_pcl_seq(str(tmp_path / "p"), "scene", seqs, rgbs, fps=3)
    jdir = jexport.export_pcl_seq(str(tmp_path / "j"), "scene", seqs, rgbs, fps=3)
    files = sorted(os.listdir(pdir))
    assert files == sorted(os.listdir(jdir))
    assert "animation.gif" in files or "contact_sheet.png" in files
    assert [f for f in files if f.endswith(".ply")] == [f"frame_{i:04d}.ply" for i in range(3)]
    for name in files:
        if name.endswith((".ply", ".html")):
            assert _bytes(os.path.join(pdir, name)) == _bytes(os.path.join(jdir, name)), name
    assert len(_ply_rows(os.path.join(pdir, "frame_0002.ply"))) == 17


def test_export_without_matplotlib(tmp_path, monkeypatch):
    """The card's machine has no matplotlib: PLY frames and viewer.html,
    no animation, one line (once per sink from log_once), no exception."""
    rng = np.random.default_rng(3)
    seqs = _tracks(rng, 2, 2, 9)
    _no_animation_in_jax(monkeypatch)
    jdir = jexport.export_pcl_seq(str(tmp_path / "j"), "scene", seqs, fps=2)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    said = []
    note = export.log_once(said.append)
    for name in ("scene", "again"):
        pdir = export.export_pcl_seq(str(tmp_path / "p"), name, seqs, fps=2, note=note)
        assert sorted(os.listdir(pdir)) == ["frame_0000.ply", "frame_0001.ply", "viewer.html"]
    assert said == [export.NO_ANIMATION]
    for name in sorted(os.listdir(jdir)):
        assert _bytes(tmp_path / "p" / "scene" / name) == _bytes(os.path.join(jdir, name))


@pytest.mark.parametrize("offset, per_edge", [((0.0, 0.0, 0.0), 24), (export.PRED_OFFSET, 24),
                                              ((0.5, -1.0, 2.0), 5)])
def test_nocs_cube_points_match_jax(offset, per_edge):
    got = export.nocs_cube_points(offset, per_edge)
    want = jexport.nocs_cube_points(offset, per_edge)
    assert got.dtype == want.dtype and got.shape == (12 * per_edge, 3)
    np.testing.assert_array_equal(got, want)


def _contour_neglogp():
    """-log-probabilities of float32 points on the contour radii, as the
    reconstruct gives them (T, N): values that sit near a 4-decimal
    rounding boundary split a contour, in both packages alike."""
    rng = np.random.default_rng(4)
    radii = np.repeat(np.asarray(export.SAMPLE_CONTOURS_RADII, np.float32), 8)
    pts = rng.standard_normal((2, radii.size, 3)).astype(np.float32)
    pts *= radii[None, :, None] / np.linalg.norm(pts, axis=-1, keepdims=True)
    logp = (-0.5 * np.log(2 * np.pi) - pts ** 2 / 2).sum(-1).astype(np.float32)
    return -logp


COLOUR_CASES = {
    "error": lambda m, rng: m.get_error_colors(rng.random((40, 3)), rng.random((40, 3))),
    "logprob": lambda m, rng: m.get_logprob_colors(rng.random((4, 40)) * 10),
    "sphere": lambda m, rng: m.get_sphere_samp_colors(_contour_neglogp()),
    "sphere_rounded": lambda m, rng: m.get_sphere_samp_colors(np.round(rng.random((4, 40)), 1)),
    # values apart in the fourth decimal, and two either side of a boundary
    "sphere_decimals": lambda m, rng: m.get_sphere_samp_colors(
        np.array([[1.0, 1.0002, 1.00049, 1.00051, 2.0, 2.00001, 3.0, 3.0004]])),
    "np_to_list": lambda m, rng: m.np_to_list(rng.random((2, 3, 5, 4)).astype(np.float32)),
    "shift": lambda m, rng: m.shift_pcl_list([rng.random((5, 3)).astype(np.float32)] * 2,
                                             m.BASE_OFFSET),
}


@pytest.mark.parametrize("case", sorted(COLOUR_CASES))
def test_colour_helpers_match_jax(case):
    got = COLOUR_CASES[case](export, np.random.default_rng(5))
    want = COLOUR_CASES[case](jexport, np.random.default_rng(5))
    got, want = (x if isinstance(x, list) else [x] for x in (got, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _poses(rng, n):
    cams = []
    for _ in range(n):
        q, r = np.linalg.qr(rng.standard_normal((3, 3)))
        cam = np.eye(4)
        cam[:3, :3] = q * np.sign(np.diag(r))
        cam[:3, 3] = rng.standard_normal(3)
        cams.append(cam)
    return cams


def test_camera_frustum_points_match_jax():
    rng = np.random.default_rng(6)
    for cam, color in zip(_poses(rng, 3), ((0.0, 1.0, 0.0), (1.0, 0.0, 0.0), (0.2, 0.3, 0.4))):
        got, want = ev._camera_frustum_points(cam, color=color), jev._camera_frustum_points(
            cam, color=color)
        assert got[0].shape == (64, 3)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_export_pose_scene_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    t, n = 3, 16
    clouds = [[rng.random((n, 3)).astype(np.float32) for _ in range(t)] for _ in range(5)]
    args = (clouds[0], clouds[1], clouds[2], clouds[3], clouds[4], _poses(rng, t),
            _poses(rng, t))
    _no_animation_in_jax(monkeypatch)
    jdir = jev._export_pose_scene(str(tmp_path / "j"), "pose_m_s", *args)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    pdir = ev._export_pose_scene(str(tmp_path / "p"), "pose_m_s", *args, note=lambda line: None)
    files = sorted(os.listdir(pdir))
    assert files == sorted(os.listdir(jdir)) == [f"frame_{i:04d}.ply" for i in range(t)] + [
        "viewer.html"]
    for name in files:
        assert _bytes(os.path.join(pdir, name)) == _bytes(os.path.join(jdir, name)), name
    assert len(_ply_rows(os.path.join(pdir, "frame_0000.ply"))) == 4 * n + 2 * 64


# ------------------------- times and options ----------------------------


@pytest.mark.parametrize("num", [1, 2, 7, 30, 64, 100, 1000])
def test_interpolation_times_bit_equal_jnp_linspace(num):
    got = cli_viz.interpolation_times(num).numpy()
    want = np.asarray(jnp.linspace(0.0, 1.0, num))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_viz_flag_surface_matches_jax(jax_viz):
    assert _actions(config.get_viz_options) == _actions(jconfig.get_viz_options)
    argv = ["--data-cfg", "x.cfg", "--viz-tnocs", "--sample-contours", "--no-constant",
            "--num-sampled-steps", "12", "--no-nocs-cubes", "--seed", "3", "--radii", "0.1"]
    assert vars(cli_viz.parse_args(argv)) == vars(jax_viz.parse_args(argv))


# ----------------------------- reconstruct ------------------------------


class _JittedModel(JaxModel):
    """The JAX model with encode and reconstruct under jax.jit: the root
    viz.py calls them eagerly, the same operations without the compile
    cache, several times slower at this size."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self._encode = jax.jit(functools.partial(JaxModel.encode, self))
        self._reconstruct = jax.jit(
            functools.partial(JaxModel.reconstruct, self),
            static_argnames=("num_points", "constant_in_time", "sample_contours"))

    def encode(self, params, x):
        return self._encode(params, x)

    def reconstruct(self, *args, sample_contours=None, **kwargs):
        contours = None if sample_contours is None else tuple(sample_contours)
        return self._reconstruct(*args, sample_contours=contours, **kwargs)


@pytest.fixture(scope="module")
def jax_viz():
    """The root viz.py as a module, loaded without its persistent compile
    cache (a process-wide JAX setting)."""
    patch = pytest.MonkeyPatch()
    patch.setattr(jruntime, "enable_compile_cache", lambda *args, **kwargs: None)
    try:
        spec = importlib.util.spec_from_file_location("jax_viz_cli", os.path.join(REPO, "viz.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        patch.undo()
    return module


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """numpy weights at JCFG (the CNF's field scaled up, as in
    tests/test_torch_port_model.py), and a JAX checkpoint of them."""
    shapes = jax.eval_shape(functools.partial(jax_caspr_init, cfg=JCFG), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params, state = _numpy_weights(shapes[0], rng), _numpy_weights(shapes[1], rng, "/point_cnf")
    path = str(tmp_path_factory.mktemp("ckpt") / "viz_weights.pkl")
    jcheckpoint.save_checkpoint(path, params, state)
    return path, params, state


@pytest.fixture(scope="module")
def jmodel():
    return _JittedModel(JCFG)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_synthetic_tree(str(tmp_path_factory.mktemp("tree")), seed=3, num_pts=2048,
                                split_sizes={"test": 2})


@pytest.mark.parametrize("base", ["gaussian", "contours"])
def test_reconstruct_viz_settings_matches_jax(weights, jmodel, base):
    _, params_np, state_np = weights
    rng = np.random.default_rng(8)
    x = rng.random((1, T, N, 4), dtype=np.float32)
    x[..., 3] = np.linspace(0.0, 5.0, T, dtype=np.float32)[None, :, None]
    times = cli_viz.interpolation_times(S)
    contours = export.SAMPLE_CONTOURS_RADII if base == "contours" else None
    as_j = lambda tree_: jax.tree_util.tree_map(jnp.asarray, tree_)
    y, logp, rec, _, nfe = jmodel.reconstruct(
        as_j(params_np), as_j(state_np), jnp.asarray(x), jax.random.PRNGKey(9), num_points=Q,
        constant_in_time=True, timestamps=jnp.asarray(times.numpy()), sample_contours=contours)
    y = np.array(y)  # writable, for torch.from_numpy
    assert y.shape == (1, S, Q, 3) and all(np.array_equal(y[:, 0], y[:, k]) for k in range(S))

    cfg = CaSPRConfig(**TINY, radii_list=JCFG.radii_list)
    params, state = params_from_jax(params_np, state_np, cfg, device="cpu")
    model = CaSPRModel(cfg, device="cpu")
    py, plogp, prec, _, pnfe = model.reconstruct(
        params, state, torch.from_numpy(x), None, num_points=Q, constant_in_time=True,
        timestamps=times, base_samples=torch.from_numpy(y))
    assert pnfe == tuple(float(v) for v in nfe)
    np.testing.assert_allclose(prec.numpy(), np.asarray(rec), rtol=0, atol=POINT_TOL)
    np.testing.assert_allclose(plogp.numpy(), np.asarray(logp), rtol=0, atol=POINT_TOL)

    # the port's own draw at these settings: constant in time, on the radii
    sy = model.reconstruct(params, state, torch.from_numpy(x), torch.Generator().manual_seed(1),
                           num_points=Q, constant_in_time=True, timestamps=times,
                           sample_contours=contours)[0]
    assert all(torch.equal(sy[:, 0], sy[:, k]) for k in range(S))
    if contours:
        norms = torch.linalg.vector_norm(sy[0, 0], dim=-1).numpy()
        per = Q // len(contours)
        want = np.concatenate([np.full(per, r) for r in contours[:-1]]
                              + [np.full(Q - per * (len(contours) - 1), contours[-1])])
        np.testing.assert_allclose(norms, want, rtol=1e-6)


# ---------------------------- command lines -----------------------------


def _tiny(flags):
    return dataclasses.replace(config.caspr_config_from_flags(flags), **TINY)


def test_viz_cli_matches_jax(tree, weights, jax_viz, jmodel, tmp_path, monkeypatch):
    path = weights[0]
    argv = ["--data-cfg", tree, "--weights", path, "--seq-len", str(T), "--num-pts", str(N),
            "--num-sampled-pts", str(Q), "--num-sampled-steps", str(S), "--viz-tnocs",
            "--tnocs-err-map", "--viz-observed", "--viz-interpolated", "--radii", *RADII]
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")

    def jax_model(cfg):
        assert cfg == JCFG
        return jmodel

    def zeros_init(key, cfg):  # --weights replaces every leaf
        shapes = jax.eval_shape(functools.partial(jax_caspr_init, cfg=cfg), key)
        return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    monkeypatch.setattr(jax_viz, "caspr_config_from_flags",
                        lambda f: dataclasses.replace(jconfig.caspr_config_from_flags(f), **TINY))
    monkeypatch.setattr(jax_viz, "CaSPRModel", jax_model)
    monkeypatch.setattr(jax_viz, "caspr_init", zeros_init)
    _no_animation_in_jax(monkeypatch)
    jax_viz.main(jax_viz.parse_args(argv + ["--out", jout]))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(cli_viz, "caspr_config_from_flags", _tiny)
    cli_viz.main(argv + ["--out", pout], device="cpu")

    seqs = [f"test_{i:04d}_seq_00000000" for i in range(2)]
    scenes = sorted(f"{s}_{k}" for s in seqs for k in ("tnocs", "observed", "interpolated"))
    assert sorted(d for d in os.listdir(pout) if os.path.isdir(os.path.join(pout, d))) == scenes
    assert sorted(d for d in os.listdir(jout) if os.path.isdir(os.path.join(jout, d))) == scenes
    for scene in scenes:
        kind = scene.rsplit("_", 1)[1]
        frames = S if kind == "interpolated" else T
        files = sorted(os.listdir(os.path.join(pout, scene)))
        assert files == sorted(os.listdir(os.path.join(jout, scene)))
        assert files == [f"frame_{i:04d}.ply" for i in range(frames)] + ["viewer.html"]
        pred = N if kind == "tnocs" else Q
        rows = 2 * N + pred + (0 if kind == "tnocs" else Q) + CUBE_ROWS
        for name in files[:-1]:
            got = _ply_rows(os.path.join(pout, scene, name))
            want = _ply_rows(os.path.join(jout, scene, name))
            assert len(got) == len(want) == rows, (scene, name)
            # ground truth and input, then the cubes: the same bytes
            assert got[:2 * N] == want[:2 * N] and got[-CUBE_ROWS:] == want[-CUBE_ROWS:]
            if kind == "tnocs":
                np.testing.assert_allclose(_coords(got[2 * N:3 * N]), _coords(want[2 * N:3 * N]),
                                           rtol=0, atol=PLY_TNOCS_TOL)
        got, want = (_viewer_payload(os.path.join(d, scene, "viewer.html")) for d in (pout, jout))
        assert got["num_frames"] == want["num_frames"] == frames
        assert len(got["tracks"]) == len(want["tracks"]) == (4 if kind == "tnocs" else 5)
        for i in (0, 1, -1):
            assert got["tracks"][i] == want["tracks"][i], (scene, i)

    log = open(os.path.join(pout, "viz_log.txt")).read()
    assert log.count(export.NO_ANIMATION) == 1
    for scene in scenes:
        assert re.search(r"\[export %s\] [0-9.]+s" % scene, log)
    for seq in seqs:
        for model_run in ("observed", "interpolated"):
            assert re.search(r"\[model %s_%s\] [0-9.]+s" % (seq, model_run), log)
    values = [float(v) for v in re.findall(r"Cur Mean (?:Chamfer|EMD): (\S+)", log)]
    assert len(values) == 4 and np.all(np.isfinite(values))


def test_viz_cli_tnocs_only_runs_the_encoder(tree, weights, tmp_path, monkeypatch):
    """--viz-tnocs alone encodes and decodes nothing (viz.py:121-122)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(cli_viz, "caspr_config_from_flags", _tiny)
    monkeypatch.setattr(CaSPRModel, "reconstruct", None)
    out = str(tmp_path / "port")
    cli_viz.main(["--data-cfg", tree, "--weights", weights[0], "--seq-len", str(T), "--num-pts",
                  str(N), "--viz-tnocs", "--no-input-seq", "--no-nocs-cubes", "--radii", *RADII,
                  "--out", out], device="cpu")
    scene = os.path.join(out, "test_0000_seq_00000000_tnocs")
    assert len(_ply_rows(os.path.join(scene, "frame_0000.ply"))) == 2 * N
    assert "[model test_0000_seq_00000000_tnocs]" in open(os.path.join(out, "viz_log.txt")).read()


def test_viz_cli_without_cuda_raises(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_viz.main(["--data-cfg", tree, "--out", str(tmp_path), "--viz-observed"])


def test_test_cli_show_pose_viz(tree, weights, tmp_path, monkeypatch):
    """One pose scene per sequence, T frames of the four clouds and the two
    camera frusta; no animation without matplotlib, said once."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(cli_test, "caspr_config_from_flags", _tiny)
    out = str(tmp_path / "port")
    cli_test.main(["--data-cfg", tree, "--weights", weights[0], "--out", out, "--seq-len", "10",
                   "--num-pts", "2048", "--batch-size", "2", "--radii", *RADII,
                   "--eval-pose-observed-ransac", "--show-pose-viz"], device="cpu")
    scenes = sorted(d for d in os.listdir(out) if d.startswith("pose_"))
    assert scenes == [f"pose_test_{i:04d}_seq_00000000" for i in range(2)]
    for scene in scenes:
        files = sorted(os.listdir(os.path.join(out, scene)))
        assert files == [f"frame_{i:04d}.ply" for i in range(10)] + ["viewer.html"]
        rows = _ply_rows(os.path.join(out, scene, "frame_0009.ply"))
        assert len(rows) == 4 * 2048 + 2 * 64
        assert np.all(np.isfinite(_coords(rows)))
    assert open(os.path.join(out, "test_log.txt")).read().count(export.NO_ANIMATION) == 1


# ------------------------------ profiling -------------------------------


def test_profiling_helpers(tmp_path):
    lines = []
    with profiling.wallclock("scope", sink=lines.append):
        pass
    assert len(lines) == 1 and re.fullmatch(r"\[scope\] \d+\.\d{3}s", lines[0])
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("viz_scene"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.key == "viz_scene" for e in prof.key_averages())
    (name,) = os.listdir(tmp_path / "trace")
    assert re.fullmatch(r"trace_\d{8}_\d{6}_\d+\.json", name)
    with open(tmp_path / "trace" / name) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "viz_scene" for e in events)
