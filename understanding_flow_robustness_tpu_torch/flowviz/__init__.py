"""Flow visualisation (the port's own copy of what it needs from
``understanding_flow_robustness_tpu/flowviz/flowlib.py``; numpy only)."""

from .flowlib import compute_color, flow_to_image, make_color_wheel

__all__ = ["compute_color", "flow_to_image", "make_color_wheel"]
