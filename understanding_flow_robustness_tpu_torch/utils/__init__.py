"""Host-side utilities: the meters and loggers of the patch and universal
CLIs, the embedding analyses (MMD, t-SNE), the host-to-device copy the
attacks and CLIs share, profiling and seeding (``profiling``), the
visualization helpers (``viz``) and the flax ``.msgpack`` codec
(``msgpack``)."""

import numpy as np
import torch

from .embedding import gaussian_mmd, tsne
from .meters import AverageMeter, CsvLogger, TermLogger, make_summary_writer
from .profiling import StepTimer, profile_trace, seed_everything
from .viz import tensor2array, transpose_image


def on_device(x, device) -> torch.Tensor:
    """``x`` (a numpy array or anything ``np.asarray`` takes) as an f32
    tensor on ``device``."""
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


__all__ = ["AverageMeter", "CsvLogger", "StepTimer", "TermLogger",
           "gaussian_mmd", "make_summary_writer", "on_device",
           "profile_trace", "seed_everything", "tensor2array",
           "transpose_image", "tsne"]
