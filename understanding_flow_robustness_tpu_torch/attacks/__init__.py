"""Global adversarial attacks on torch autograd (counterpart of
``understanding_flow_robustness_tpu/attacks/``): FGSM, I-FGSM, I-FGM,
MI-FGSM, Gaussian and uniform noise, the diverse-input transform, their
losses, the evaluation runner and its logs.  The patch attack, the
universal trainer, ``patch3d`` and the corruptions are ROADMAP A8's open
part."""

from . import eval_utils, log_utils
from .global_attacks import (
    PerturbConfig,
    apply_diverse_input,
    diverse_input,
    fgsm,
    gaussian_noise,
    ifgsm,
    make_attack,
    mifgsm,
    perturb,
    perturb_trajectory,
    uniform_noise,
)
from .losses import (
    compute_cossim,
    compute_epe,
    compute_l1,
    cosine_similarity,
    flow_attack_loss,
    multiscale_cossim,
)
from .perturb_runner import RunConfig, build_arbitrary_gt
from .perturb_runner import run as run_perturbation_eval

__all__ = [
    "PerturbConfig",
    "RunConfig",
    "apply_diverse_input",
    "build_arbitrary_gt",
    "compute_cossim",
    "compute_epe",
    "compute_l1",
    "cosine_similarity",
    "diverse_input",
    "eval_utils",
    "fgsm",
    "flow_attack_loss",
    "gaussian_noise",
    "ifgsm",
    "log_utils",
    "make_attack",
    "mifgsm",
    "multiscale_cossim",
    "perturb",
    "perturb_trajectory",
    "run_perturbation_eval",
    "uniform_noise",
]
