"""Flow and image file I/O, flow visualisation and the flow analysis
helpers (the port's own copies of ``understanding_flow_robustness_tpu/
flowviz/``; numpy, scipy and the port's host library only)."""

from .flow_viz import batch_compute_flow_image, compute_flow_image
from .flowlib import (
    UNKNOWN_FLOW_THRESH,
    compute_color,
    disp_to_flowfile,
    evaluate_flow,
    flow_error,
    flow_to_image,
    interp_gt_flow,
    make_color_wheel,
    scale_image,
    segment_flow,
)
from .io import (
    read_disparity_png,
    read_flo,
    read_flow_png,
    read_gen,
    read_image,
    read_paths,
    read_pfm,
    read_samples,
    write_flo,
    write_flow_png,
    write_image,
    write_paths,
    write_pfm,
)

__all__ = [
    "UNKNOWN_FLOW_THRESH",
    "batch_compute_flow_image",
    "compute_color",
    "compute_flow_image",
    "disp_to_flowfile",
    "evaluate_flow",
    "flow_error",
    "flow_to_image",
    "interp_gt_flow",
    "make_color_wheel",
    "scale_image",
    "segment_flow",
    "read_disparity_png",
    "read_flo",
    "read_flow_png",
    "read_gen",
    "read_image",
    "read_paths",
    "read_pfm",
    "read_samples",
    "write_flo",
    "write_flow_png",
    "write_image",
    "write_paths",
    "write_pfm",
]
