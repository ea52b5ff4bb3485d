"""Headless scene export (counterpart of caspr_tpu/viz): PLY frames, a
standalone WebGL viewer and, where matplotlib imports, an animation."""

from .export import (
    save_ply,
    export_pcl_seq,
    get_error_colors,
    get_logprob_colors,
    get_sphere_samp_colors,
    np_to_list,
    shift_pcl_list,
    SAMPLE_CONTOURS_RADII,
    PRED_OFFSET,
    BASE_OFFSET,
)
from .html_viewer import export_html_viewer
