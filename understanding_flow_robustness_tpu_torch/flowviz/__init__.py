"""Flow and image file I/O and flow visualisation (the port's own copies of
``understanding_flow_robustness_tpu/flowviz/``; numpy and the port's host
library only)."""

from .flow_viz import batch_compute_flow_image, compute_flow_image
from .flowlib import compute_color, flow_to_image, make_color_wheel
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
    "batch_compute_flow_image",
    "compute_color",
    "compute_flow_image",
    "flow_to_image",
    "make_color_wheel",
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
