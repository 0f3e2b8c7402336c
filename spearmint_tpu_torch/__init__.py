"""spearmint_tpu_torch — the PyTorch/CUDA port of spearmint_tpu.

A second package beside the JAX one (``spearmint_tpu/``, the reference):
the same fully-Bayesian GP-EI suggestion (slice-sampled Matérn-5/2 ARD
hyperparameters, EI averaged over samples, pending-job fantasies, batched
projected L-BFGS) and its constrained form (a probit latent-GP classifier
of NaN-valued violations weighting EI), written in PyTorch for one NVIDIA
H100.  The Cholesky-family Pallas kernels of these paths are CUDA C++
kernels written by hand for ``sm_90a`` (``ops/csrc``), with plain PyTorch
versions beside them that serve CPU tensors (``ops/gp_kernels``).

Layout mirrors the JAX package:
  core/     kernels, masked linear algebra, GP log-marginal, priors
  mcmc/     batched slice sampler, elliptical slice sampler, chain states
  acquire/  EI, fantasization, batched L-BFGS-B
  engine/   the suggestion step, the constrained suggestion step
  ops/      the CUDA kernels, their plain versions and their build
  choosers/ GPEIOptChooser, GPEIChooser, GPConstrainedEIChooser
  store/ utils/  locking, argument parsing, event log

Entry points run on ``cuda`` unless ``device="cpu"`` is asked for; with
no card and no such request they raise.  The package imports neither
``jax`` nor ``spearmint_tpu``.
"""

__version__ = "0.1.0"

import torch as _torch

# Counterpart of spearmint_tpu/__init__.py's matmul-precision floor.
# Posterior variances are small differences of O(amp2) quantities
# (var = amp2·(1+ε) − Σβ², var/amp2 down at 1e-4, acquire/ei.py), and
# TF32 keeps ~10 mantissa bits — fewer than the bf16_3x the JAX package
# measured at 1.5e-4 absolute error on Σβ².  So every float32 product
# (matmul and cuDNN alike) runs in full float32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
