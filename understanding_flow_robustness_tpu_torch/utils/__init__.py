"""Host-side utilities: the meters and loggers of the patch and universal
CLIs, the embedding analyses (MMD, t-SNE) and the host-to-device copy the
attacks and CLIs share."""

import numpy as np
import torch

from .embedding import gaussian_mmd, tsne
from .meters import AverageMeter, CsvLogger, TermLogger, make_summary_writer


def on_device(x, device) -> torch.Tensor:
    """``x`` (a numpy array or anything ``np.asarray`` takes) as an f32
    tensor on ``device``."""
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


__all__ = ["AverageMeter", "CsvLogger", "TermLogger", "gaussian_mmd",
           "make_summary_writer", "on_device", "tsne"]
