"""PyTorch + CUDA port of the optical-flow robustness suite.

The JAX package ``understanding_flow_robustness_tpu`` is the reference this
package is held against (tests/test_torch_*.py).  This package imports
``torch`` and never ``jax``.

Layout mirrors the reference package where that helps a reader find a
module's counterpart: ``ops/`` (plain PyTorch operators and the wrappers of
the hand-written kernels), ``models/`` (``nn.Module``s in NCHW, keeping the
original PyTorch repository's parameter names) and ``csrc/`` (CUDA sources,
compiled with ``nvcc`` for ``sm_90a`` at first use, ``ops/_build.py``).

Ported so far: RAFT-12 inference (``models.fetch_model("RAFT")`` and
``predict_flow``) with the correlation lookup as a CUDA kernel
(``csrc/alt_corr_fwd.cu``).
"""

__version__ = "0.1.0"
