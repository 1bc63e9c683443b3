"""PyTorch + CUDA port of the optical-flow robustness suite.

The JAX package ``understanding_flow_robustness_tpu`` is the reference this
package is held against (tests/test_torch_*.py).  This package imports
``torch`` and never ``jax``.

Layout mirrors the reference package where that helps a reader find a
module's counterpart: ``ops/`` (plain PyTorch operators and the wrappers of
the hand-written kernels), ``models/`` (``nn.Module``s in NCHW, keeping the
original PyTorch repository's parameter names), ``attacks/`` (the global
and patch attacks and the universal perturbation on torch autograd),
``flowviz/``, ``training/``, ``utils/`` (meters and loggers), ``cli/`` and
``csrc/`` (CUDA sources, compiled with ``nvcc`` for ``sm_90a`` at first
use, ``ops/_build.py``).

Ported so far: RAFT-12 inference and training (``models.fetch_model(
"RAFT")``, ``predict_flow``, ``training``) with the correlation lookup and
its gradients as CUDA kernels (``csrc/alt_corr_fwd.cu``,
``csrc/alt_corr_bwd.cu``, and ``csrc/alt_corr_dcoords.cu`` for the
coordinates); RAFT's volume path (``csrc/corr_lookup_fwd.cu``), its taps
and the WoContext variant; SPyNet and PWC-Net inference (``"SpyNet"``,
``"PWCNet"``, ``"PWCNet_adv_ifgsm_l2_002"``) with the backward warp as a
CUDA kernel (``csrc/warp_fwd.cu``); the FlowNet family with the spatial
correlation and its gradient as CUDA kernels (``csrc/spatial_corr_fwd.cu``,
``csrc/spatial_corr_bwd.cu``); the FGSM-family and noise attacks on every
ported model (``attacks``, ``cli.run_perturb_model``); the patch attacks,
their 3-D true-motion placement and the universal perturbation
(``cli.patch_attack``, ``cli.test_patch``, ``cli.universal_perturbation``).
Entry points run on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
