"""Operators: plain PyTorch, plus the wrappers of the CUDA kernels."""

from ._build import LAUNCH_COUNTS
from .correlation import (
    all_pairs_correlation,
    alt_corr_coords_grad_reference,
    alt_corr_features,
    alt_corr_kernel_inputs,
    alt_corr_lookup,
    alt_corr_lookup_backward_reference,
    alt_corr_lookup_reference,
    channel_norm,
    corr_lookup,
    corr_lookup_fwd,
    corr_lookup_reference,
    corr_pyramid,
    pool_fmap_levels,
    prepare_alt_corr,
    spatial_correlation,
    spatial_correlation_reference,
    volume_pyramid,
)
from .interp import (
    avg_pool2,
    bilinear_sample,
    coords_grid,
    resize_bilinear,
    unnormalize_coords,
    warp_backward_reference,
)
from .warp import warp_backward

__all__ = [
    "LAUNCH_COUNTS",
    "all_pairs_correlation",
    "alt_corr_coords_grad_reference",
    "alt_corr_features",
    "alt_corr_kernel_inputs",
    "alt_corr_lookup",
    "alt_corr_lookup_backward_reference",
    "alt_corr_lookup_reference",
    "avg_pool2",
    "bilinear_sample",
    "channel_norm",
    "coords_grid",
    "corr_lookup",
    "corr_lookup_fwd",
    "corr_lookup_reference",
    "corr_pyramid",
    "pool_fmap_levels",
    "prepare_alt_corr",
    "resize_bilinear",
    "spatial_correlation",
    "spatial_correlation_reference",
    "unnormalize_coords",
    "volume_pyramid",
    "warp_backward",
    "warp_backward_reference",
]
