"""Adversarial attacks on torch autograd (counterpart of
``understanding_flow_robustness_tpu/attacks/``): FGSM, I-FGSM, I-FGM,
MI-FGSM, Gaussian and uniform noise, the diverse-input transform, their
losses, the evaluation runner and its logs; the universal patch attack
(patch construction and placement, ``patch3d``'s true-motion projection,
the patch training and validation loops), the universal perturbation
trainer and the image corruptions (``corruptions``, numpy, scipy and cv2
on the host)."""

from . import corruptions, eval_utils, log_utils
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
from .patch import (
    circle_transform,
    circle_transform_different,
    circle_transform_two_patches,
    create_circular_mask,
    create_correlated_patch,
    create_random_patch,
    extract_patch,
    get_patch_and_mask,
    get_self_correlated_patches,
    init_patch_circle,
    init_patch_from_image,
    init_patch_square,
    rezoom_to,
    square_transform,
)
from .patch3d import project_patch_3d_scene
from .patch_attack import (
    PatchAttackConfig,
    make_patch_attack_step,
    train_patch_epoch,
    validate_patch,
)
from .perturb_runner import RunConfig, build_arbitrary_gt
from .perturb_runner import run as run_perturbation_eval
from .universal import (
    UniversalConfig,
    make_universal_attack_step,
    train_universal_perturbation,
)

__all__ = [
    "PatchAttackConfig",
    "PerturbConfig",
    "RunConfig",
    "UniversalConfig",
    "apply_diverse_input",
    "build_arbitrary_gt",
    "circle_transform",
    "circle_transform_different",
    "circle_transform_two_patches",
    "compute_cossim",
    "corruptions",
    "compute_epe",
    "compute_l1",
    "cosine_similarity",
    "create_circular_mask",
    "create_correlated_patch",
    "create_random_patch",
    "diverse_input",
    "eval_utils",
    "extract_patch",
    "fgsm",
    "flow_attack_loss",
    "gaussian_noise",
    "get_patch_and_mask",
    "get_self_correlated_patches",
    "ifgsm",
    "init_patch_circle",
    "init_patch_from_image",
    "init_patch_square",
    "log_utils",
    "make_attack",
    "make_patch_attack_step",
    "make_universal_attack_step",
    "mifgsm",
    "multiscale_cossim",
    "perturb",
    "perturb_trajectory",
    "project_patch_3d_scene",
    "rezoom_to",
    "run_perturbation_eval",
    "square_transform",
    "train_patch_epoch",
    "train_universal_perturbation",
    "uniform_noise",
    "validate_patch",
]
