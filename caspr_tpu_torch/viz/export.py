"""Headless visualisation export (the port's own copy of
caspr_tpu/viz/export.py).

The reference ships an interactive Qt5/OpenGL viewer
(reference caspr/utils/pcl_viewer.py); a headless host exports the same
composed scenes instead: per-frame PLY point clouds (colours included), a
standalone HTML viewer and, where matplotlib imports, an animation (GIF
when Pillow is available, else a PNG contact sheet).  The PLY text and the
viewer's payload are byte for byte those of the JAX package for the same
arrays.  Colour conventions (T-NOCS RGB, error maps, log-prob maps,
contour colours) follow reference caspr/utils/viz_utils.py:222-285.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np

# std contours for sampling from gaussian (viz_utils.py:13)
SAMPLE_CONTOURS_RADII = [0.25, 0.5, 1.0, 1.5, 2.25, 3.0]
# offsets used to place predictions / base samples beside the GT cube
PRED_OFFSET = [1.0, 0.0, 0.0]
BASE_OFFSET = [2.5, 0.5, 0.5]

NO_ANIMATION = ("matplotlib is not installed: no animation written "
                "(the scenes' PLY frames and viewer.html are)")


def save_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None):
    """ASCII PLY writer: points (N,3), colors (N,3) floats in [0,1]."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    has_color = colors is not None
    if has_color:
        colors = np.clip(np.asarray(colors), 0.0, 1.0)
        rgb = (colors * 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_color:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i,0]:.6f} {points[i,1]:.6f} {points[i,2]:.6f}"
            if has_color:
                row += f" {rgb[i,0]} {rgb[i,1]} {rgb[i,2]}"
            f.write(row + "\n")


def log_once(sink: Callable[[str], None] = print) -> Callable[[str], None]:
    """A sink that passes each distinct line on to ``sink`` the first time
    only (so a run of many scenes says once that it wrote no animation)."""
    said = set()

    def note(line: str):
        if line not in said:
            said.add(line)
            sink(line)

    return note


def export_pcl_seq(
    out_dir: str,
    name: str,
    pcl_seqs: Sequence[Sequence[np.ndarray]],
    rgb_seqs: Optional[Sequence[Sequence[np.ndarray]]] = None,
    fps: int = 10,
    note: Callable[[str], None] = print,
):
    """Export a multi-track animated point-cloud scene.

    pcl_seqs: list of tracks; each track is a list of (N,3) frames (the
    composition the reference feeds viz_pcl_seq, pcl_viewer.py:261).
    Writes <out>/<name>/frame_####.ply (tracks merged per frame),
    viewer.html and, where matplotlib imports, an animation (gif or png
    sheet); without matplotlib ``note`` gets ``NO_ANIMATION``.
    """
    scene_dir = os.path.join(out_dir, name)
    os.makedirs(scene_dir, exist_ok=True)
    num_frames = max(len(track) for track in pcl_seqs)

    merged_frames = []
    merged_colors = []
    for fi in range(num_frames):
        pts, cols = [], []
        for ti, track in enumerate(pcl_seqs):
            frame = track[min(fi, len(track) - 1)]
            pts.append(np.asarray(frame)[:, :3])
            if rgb_seqs is not None and rgb_seqs[ti] is not None:
                cf = rgb_seqs[ti][min(fi, len(rgb_seqs[ti]) - 1)]
                cols.append(np.asarray(cf)[:, :3])
            else:
                cols.append(np.ones_like(pts[-1]) * 0.5)
        merged_frames.append(np.concatenate(pts, axis=0))
        merged_colors.append(np.clip(np.concatenate(cols, axis=0), 0, 1))
        save_ply(
            os.path.join(scene_dir, f"frame_{fi:04d}.ply"),
            merged_frames[-1],
            merged_colors[-1],
        )

    if not _export_animation(scene_dir, merged_frames, merged_colors, fps):
        note(NO_ANIMATION)
    from .html_viewer import export_html_viewer

    export_html_viewer(
        os.path.join(scene_dir, "viewer.html"),
        pcl_seqs,
        rgb_seqs,
        fps=fps,
    )
    return scene_dir


def _export_animation(scene_dir, frames, colors, fps) -> bool:
    """animation.gif, or contact_sheet.png where the GIF cannot be written;
    returns False, writing nothing, where matplotlib does not import."""
    try:
        import matplotlib
    except ImportError:
        return False

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    all_pts = np.concatenate(frames, axis=0)
    lo, hi = all_pts.min(axis=0), all_pts.max(axis=0)
    try:
        from matplotlib.animation import FuncAnimation, PillowWriter

        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(111, projection="3d")

        def draw(fi):
            ax.clear()
            ax.scatter(
                frames[fi][:, 0], frames[fi][:, 2], frames[fi][:, 1],
                c=colors[fi], s=1
            )
            ax.set_xlim(lo[0], hi[0])
            ax.set_ylim(lo[2], hi[2])
            ax.set_zlim(lo[1], hi[1])
            ax.set_title(f"frame {fi}")

        anim = FuncAnimation(fig, draw, frames=len(frames))
        anim.save(
            os.path.join(scene_dir, "animation.gif"),
            writer=PillowWriter(fps=max(1, fps)),
        )
        plt.close(fig)
    except Exception:
        # contact sheet fallback
        cols_n = min(5, len(frames))
        rows_n = (len(frames) + cols_n - 1) // cols_n
        fig, axes = plt.subplots(
            rows_n, cols_n, figsize=(3 * cols_n, 3 * rows_n),
            subplot_kw={"projection": "3d"}
        )
        axes = np.atleast_1d(axes).reshape(-1)
        for fi, ax in enumerate(axes):
            if fi < len(frames):
                ax.scatter(
                    frames[fi][:, 0], frames[fi][:, 2], frames[fi][:, 1],
                    c=colors[fi], s=1
                )
                ax.set_xlim(lo[0], hi[0])
                ax.set_ylim(lo[2], hi[2])
                ax.set_zlim(lo[1], hi[1])
            ax.set_axis_off()
        fig.savefig(os.path.join(scene_dir, "contact_sheet.png"), dpi=80)
        plt.close(fig)
    return True


def nocs_cube_points(offset=(0.0, 0.0, 0.0), pts_per_edge: int = 24):
    """Wireframe unit cube sampled as points (the reference viewer draws
    NOCS wire cubes, pcl_viewer.py:174-180; point tracks are the headless
    equivalent).  Returns (12*pts_per_edge, 3)."""
    corners = np.array(
        [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
        np.float32,
    )
    edges = [
        (0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3),
        (2, 6), (3, 7), (4, 5), (4, 6), (5, 7), (6, 7),
    ]
    t = np.linspace(0.0, 1.0, pts_per_edge, dtype=np.float32)[:, None]
    pts = np.concatenate(
        [corners[a] * (1 - t) + corners[b] * t for a, b in edges], axis=0
    )
    return pts + np.asarray(offset, np.float32)


# ----------------------- color helpers (viz_utils.py) ----------------------


def np_to_list(arr: np.ndarray) -> List[np.ndarray]:
    """B x T x N x D -> list of (N,3), batch item 0 (viz_utils.py:222-224)."""
    return [arr[0, i, :, :3] for i in range(arr.shape[1])]


def shift_pcl_list(pcl_list, offset):
    return [p + np.array([offset]) for p in pcl_list]


def get_error_colors(predicted, gt, worst_error: float = 0.07):
    """Red channel scales with L2 error (viz_utils.py:235-244)."""
    err = np.linalg.norm(predicted - gt, axis=1)
    colors = np.ones_like(predicted)
    colors[:, 0] = np.minimum(1.0, err / worst_error)
    colors[:, 1] = 27.0 / 255.0
    colors[:, 2] = 116.0 / 255.0
    return colors


def get_logprob_colors(logprob_y, low_prob=2.0, high_prob=9.0):
    """(T,N) -logprob -> list of (N,3) colors (viz_utils.py:246-262)."""
    trans = logprob_y - low_prob
    rng = high_prob - low_prob
    t, n = logprob_y.shape
    colors = np.ones((t, n, 3))
    colors[:, :, 0] = np.minimum(1.0, trans / rng)
    colors[:, :, 1] = 27.0 / 255.0
    colors[:, :, 2] = 116.0 / 255.0
    return [colors[i] for i in range(t)]


def get_sphere_samp_colors(logprob_y):
    """Distinct colors per sampled gaussian contour (viz_utils.py:264-285).
    Points group by their -log-probability rounded to 4 decimals, as in the
    JAX package: a contour whose float32 value sits on a rounding boundary
    takes two colours."""
    palette = (
        np.array(
            [
                [153.0, 0.0, 76.0],
                [102.0, 0.0, 0.0],
                [204.0, 102.0, 0.0],
                [0.0, 102.0, 0.0],
                [0.0, 102.0, 204.0],
                [102.0, 0.0, 204.0],
            ]
        )
        / 255.0
    )
    t, n = logprob_y.shape
    _, inv = np.unique(logprob_y.round(decimals=4), return_inverse=True)
    colors = palette[inv % len(palette)].reshape(t, n, 3)
    return [colors[i] for i in range(t)]
