"""spearmint_tpu_torch — the PyTorch/CUDA port of spearmint_tpu.

A second package beside the JAX one (``spearmint_tpu/``, the reference):
the same fully-Bayesian GP-EI suggestion (slice-sampled Matérn-5/2 ARD
hyperparameters, EI averaged over samples, pending-job fantasies, batched
projected L-BFGS), its constrained form (a probit latent-GP classifier of
NaN-valued violations weighting EI) and its cost-aware form (EI per
expected second, from a second GP over log job durations), with the
experiment store and the harnesses, written in PyTorch for one NVIDIA
H100.  The Cholesky-family Pallas kernels of these paths are CUDA C++
kernels written by hand for ``sm_90a`` (``ops/csrc``), with plain PyTorch
versions beside them that serve CPU tensors (``ops/gp_kernels``).

Layout mirrors the JAX package:
  core/     kernels, masked linear algebra, GP log-marginal, priors
  mcmc/     batched slice sampler, elliptical slice sampler, chain states
  acquire/  EI, fantasization, batched L-BFGS-B
  engine/   the suggestion step, the constrained and the EI-per-second
            suggestion steps
  ops/      the CUDA kernels, their plain versions and their build
  choosers/ GPEIOptChooser, GPEIChooser, GPConstrainedEIChooser,
            GPEIperSecChooser, and the host-side Random, Sequential, Grid
            and RandomForestEI choosers
  store/    the Sobol grid, unit ↔ typed parameters, the config and job
            codec, ExperimentGrid (the on-disk experiment) and the locker
  harness/  the job runner and its drivers (local, sge, fake), the shared
            suggest loop, the asynchronous and sync harnesses,
            spearmint-lite, the web status page and the terminal view
            (``python -m spearmint_tpu_torch.harness.{main,sync,lite,watch}``)
  utils/    argument parsing, event log, device selection

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
