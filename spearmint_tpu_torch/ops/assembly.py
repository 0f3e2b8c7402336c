"""The covariance assembly's kernel: the unit covariance M in one pass.

No JAX counterpart kernel: the JAX package builds M as a chain of
element-wise operations (``core/likelihood.unit_cov_matrix``) that XLA
fuses into one loop.  PyTorch runs that chain as about 20 element-wise
kernels, each over a whole [K, N, N] buffer; ``unit_cov``
(``csrc/unit_cov.cu``) writes each element of M once, with the chain's
float32 arithmetic in the chain's order, so its M equals the chain's bit
for bit.  The chain stays the plain version (``core/likelihood``), which
also decides which route a call takes (``use_unit_cov_kernel``).

``launches`` counts the kernel's launches; each call is a
``torch.profiler`` range of the wrapper's name (``gp_kernels.ranged``).
"""

from __future__ import annotations

import torch

from spearmint_tpu_torch.ops import gp_kernels

# The covariances the kernel computes, by its ``kind`` argument (the
# order of ``Kind`` in csrc/unit_cov.cu).
KINDS = ("Matern52", "Matern32", "SquaredExp")
# The largest input dimension the kernel takes (MAX_DIM in
# csrc/unit_cov.cu): from 32 on, the chain sums by the matmul form.
MAX_DIM = 31

launches = {"unit_cov": 0}


def reset_launches() -> None:
    launches["unit_cov"] = 0


def _check_args(a: torch.Tensor, mask: torch.Tensor, kind: int) -> None:
    if a.dtype != torch.float32 or not a.is_contiguous():
        raise ValueError(f"a: want contiguous float32, got {a.dtype}, "
                         f"contiguous={a.is_contiguous()}")
    if a.ndim != 3 or not 1 <= a.shape[2] <= MAX_DIM:
        raise ValueError(f"a: want [K, N, D] with 1 <= D <= {MAX_DIM}, got "
                         f"{tuple(a.shape)}")
    if mask.dtype != torch.bool or not mask.is_contiguous():
        raise ValueError(f"mask: want contiguous bool, got {mask.dtype}, "
                         f"contiguous={mask.is_contiguous()}")
    if tuple(mask.shape) != (a.shape[1],):
        raise ValueError(f"mask: want {(a.shape[1],)}, got "
                         f"{tuple(mask.shape)}")
    if mask.device != a.device:
        raise ValueError(f"mask on {mask.device}, a on {a.device}")
    if not 0 <= kind < len(KINDS):
        raise ValueError(f"kind: want 0-{len(KINDS) - 1}, got {kind}")
    if a.device.type != "cuda":
        raise ValueError(f"a on {a.device}: the kernel runs on the card "
                         "only (its plain version is "
                         "core/likelihood.unit_cov_matrix_plain)")


@gp_kernels.ranged
def unit_cov(a: torch.Tensor, mask: torch.Tensor, jitter: float,
             kind: int) -> torch.Tensor:
    """M [K, N, N] of length-scaled points a [K, N, D] (x / ls), mask [N]:
    KINDS[kind](r) + jitter on the diagonal where both rows are real, 0
    elsewhere; jitter is taken as float32."""
    _check_args(a, mask, kind)
    from spearmint_tpu_torch.ops import build

    k_batch, n, d = a.shape
    m = torch.empty((k_batch, n, n), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        err = build.load("unit_cov").spm_unit_cov(
            gp_kernels._ptr(a), gp_kernels._ptr(mask), gp_kernels._ptr(m),
            k_batch, n, d, kind, jitter, gp_kernels._stream(a))
    gp_kernels._raise_on(err, "spm_unit_cov")
    launches["unit_cov"] += 1
    return m
