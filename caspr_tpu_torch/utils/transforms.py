"""Rotation / sphere-sampling helpers: the port's own copy of
caspr_tpu/utils/transforms.py, plain numpy, so the same functions give the
same numbers under the same ``rng``.

Pure-math re-implementation of reference caspr/utils/transform_utils.py
(which delegates quaternion/axis-angle conversion to Open3D's C++
geometry module at transform_utils.py:24,33,46)."""

from __future__ import annotations

import numpy as np

AXIS_MAP = {
    "x": np.array([1.0, 0.0, 0.0]),
    "y": np.array([0.0, 1.0, 0.0]),
    "z": np.array([0.0, 0.0, 1.0]),
}


def quaternion_to_matrix(q):
    """(w, x, y, z) -> 3x3 rotation matrix (o3d convention)."""
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def axis_angle_to_matrix(axis_angle):
    """Rodrigues formula; input is axis * angle like o3d's helper."""
    v = np.asarray(axis_angle, np.float64)
    angle = np.linalg.norm(v)
    if angle < 1e-12:
        return np.eye(3)
    k = v / angle
    kx = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], np.float64
    )
    return np.eye(3) + np.sin(angle) * kx + (1 - np.cos(angle)) * (kx @ kx)


def random_rotation(rng=None):
    """Uniform random rotation via uniform quaternion sampling
    (reference transform_utils.py:10-26, Shoemake's method)."""
    rng = rng or np.random
    u = rng.uniform(size=3)
    c1, c2 = 2 * np.pi * u[1], 2 * np.pi * u[2]
    q = np.array(
        [
            np.sqrt(1 - u[0]) * np.sin(c1),
            np.sqrt(1 - u[0]) * np.cos(c1),
            np.sqrt(u[0]) * np.sin(c2),
            np.sqrt(u[0]) * np.cos(c2),
        ]
    )
    return quaternion_to_matrix(q)


def rotation_axis(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    return axis_angle_to_matrix(axis * angle)


def random_rotation_axis(axis: str, rng=None):
    if axis not in AXIS_MAP:
        raise ValueError("Axis must be x, y, or z")
    rng = rng or np.random
    return axis_angle_to_matrix(AXIS_MAP[axis] * rng.uniform(0.0, 2 * np.pi))


def random_sphere_point(rng=None):
    rng = rng or np.random
    u = rng.uniform(-1.0, 1.0)
    theta = rng.uniform(0, 2 * np.pi)
    c = np.sqrt(1 - u * u)
    return np.array([c * np.cos(theta), c * np.sin(theta), u])


def random_sphere_points(num_points, radius=0.5, rng=None):
    """Uniform inside a sphere (transform_utils.py:63-78)."""
    rng = rng or np.random
    costheta = rng.uniform(-1.0, 1.0, num_points)
    phi = rng.uniform(0, 2 * np.pi, num_points)
    u = rng.uniform(0, 1.0, num_points)
    theta = np.arccos(costheta)
    r = radius * np.cbrt(u)
    return np.stack(
        [
            r * np.sin(theta) * np.cos(phi),
            r * np.sin(theta) * np.sin(phi),
            r * np.cos(theta),
        ],
        axis=1,
    )


def sphere_surface_points(num_points, radius=0.5, rng=None):
    """Normalized cube samples (transform_utils.py:80-85); numpy twin of
    caspr_tpu_torch.ops.sampling.sphere_surface_points."""
    rng = rng or np.random
    cube = rng.uniform(-1.0, 1.0, (num_points, 3))
    return cube / np.linalg.norm(cube, axis=1, keepdims=True) * radius


def normals_to_angles(normals):
    """(..., 3) unit normals -> (theta in [0,pi], phi in [0,2pi))
    (transform_utils.py:87-98)."""
    normals = np.asarray(normals)
    x2y2 = np.linalg.norm(normals[..., :2], axis=-1)
    theta = np.arctan(x2y2 / normals[..., 2])
    theta = np.where(theta < 0, theta + np.pi, theta)
    phi = np.arctan2(normals[..., 1], normals[..., 0])
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    return np.stack([theta, phi], axis=-1)


def angles_to_normals(angles):
    angles = np.asarray(angles)
    theta, phi = angles[..., 0], angles[..., 1]
    return np.stack(
        [
            np.sin(theta) * np.cos(phi),
            np.sin(theta) * np.sin(phi),
            np.cos(theta),
        ],
        axis=-1,
    )
