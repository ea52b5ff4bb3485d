"""Point-cloud ops, metrics, the dopri5 solver, sampling and the CUDA kernels.

The names exported here for the point-cloud primitives are the
dispatching wrappers of ``ops.kernels`` (the kernel for a CUDA tensor, the
plain version of ``ops.pointops`` for a CPU tensor)."""

from .kernels import (
    ball_query,
    ball_query_pair,
    cnf_dynamics,
    cnf_primal,
    farthest_point_sampling,
    gather_points,
    three_interpolate,
    three_nn,
)
from .metrics import approx_match_emd, chamfer_distance
from .odeint import odeint
from .pointops import group_points, pairwise_sqdist
from .sampling import sample_gaussian, sphere_surface_points, standard_normal_logprob

__all__ = [
    "approx_match_emd",
    "ball_query",
    "ball_query_pair",
    "chamfer_distance",
    "cnf_dynamics",
    "cnf_primal",
    "farthest_point_sampling",
    "gather_points",
    "group_points",
    "odeint",
    "pairwise_sqdist",
    "sample_gaussian",
    "sphere_surface_points",
    "standard_normal_logprob",
    "three_interpolate",
    "three_nn",
]
