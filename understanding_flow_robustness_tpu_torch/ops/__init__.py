"""Operators: plain PyTorch, plus the wrappers of the CUDA kernels."""

from .correlation import (
    LAUNCH_COUNTS,
    all_pairs_correlation,
    alt_corr_features,
    alt_corr_kernel_inputs,
    alt_corr_lookup,
    alt_corr_lookup_backward_reference,
    alt_corr_lookup_reference,
    corr_lookup,
    corr_pyramid,
    pool_fmap_levels,
    prepare_alt_corr,
)
from .interp import coords_grid

__all__ = [
    "LAUNCH_COUNTS",
    "all_pairs_correlation",
    "alt_corr_features",
    "alt_corr_kernel_inputs",
    "alt_corr_lookup",
    "alt_corr_lookup_backward_reference",
    "alt_corr_lookup_reference",
    "coords_grid",
    "corr_lookup",
    "corr_pyramid",
    "pool_fmap_levels",
    "prepare_alt_corr",
]
