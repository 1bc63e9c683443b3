"""Sampling helpers (counterpart of ``understanding_flow_robustness_tpu/ops/interp.py``).

Only what RAFT inference needs is ported so far.
"""

from __future__ import annotations

import torch


def coords_grid(height: int, width: int, device=None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(H, W, 2) pixel-coordinate grid, channel order (x, y).

    RAFT's coords_grid (models/raft/utils/utils.py:79-82) in the JAX
    package's channels-last layout."""
    y, x = torch.meshgrid(
        torch.arange(height, device=device, dtype=dtype),
        torch.arange(width, device=device, dtype=dtype),
        indexing="ij",
    )
    return torch.stack([x, y], dim=-1)
