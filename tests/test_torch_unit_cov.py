"""The covariance assembly: ``core/likelihood.unit_cov_matrix``'s route
rule, the CUDA kernel's wrapper (``ops/assembly.unit_cov``) and what the
tracing and the build know of it, on the CPU.

The kernel itself runs on the card only; ``tests/test_torch_gpu_kernels.py``
holds its M to the plain chain's bit for bit there.  Here the CPU route
(the plain chain) is held bit for bit to the assembly as it was written
before the kernel existed, for each covariance the kernel has.
"""

import math
import os
import re

import numpy as np
import pytest
import torch

from spearmint_tpu_torch.core import kernels, likelihood
from spearmint_tpu_torch.ops import assembly, build
from spearmint_tpu_torch.utils import trace

CU = os.path.join(build.CSRC, "unit_cov.cu")
COVS = ("Matern52", "Matern32", "SquaredExp")


def _points(k, n, d, n_real, seed):
    """Points with duplicates (r2 = 0 off the diagonal) and length scales
    over 0.01-10 (exp underflows to 0 at the short ones)."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, d)).astype(np.float32)
    x[1] = x[0]
    x[n_real - 1] = x[2]
    x[n_real:] = 0.0
    ls = np.exp(rng.uniform(np.log(0.01), np.log(10.0), (k, d)))
    mask = np.arange(n) < n_real
    return (torch.tensor(x), torch.tensor(mask),
            torch.tensor(ls.astype(np.float32)))


def _assembly_as_written_before_the_kernel(x, mask, ls, kernel):
    n = x.shape[0]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    both = mask[:, None] & mask[None, :]
    return torch.where(both, kernel(x, x, ls)
                       + likelihood._effective_jitter(n) * eye, 0.0)


# ------------------------------------------------------------- the route
@pytest.mark.parametrize("device,dtype,dim,cov,grad,want", [
    ("cuda", torch.float32, 2, "Matern52", False, True),
    ("cuda", torch.float32, 7, "Matern32", False, True),
    ("cuda", torch.float32, 1, "SquaredExp", False, True),
    ("cuda", torch.float32, 31, "ARDSE", False, True),
    ("cpu", torch.float32, 2, "Matern52", False, False),
    ("cuda", torch.float64, 2, "Matern52", False, False),
    ("cuda", torch.float16, 2, "Matern52", False, False),
    ("cuda", torch.float32, 32, "Matern52", False, False),
    ("cuda", torch.float32, 40, "SquaredExp", False, False),
    ("cuda", torch.float32, 2, "Matern52", True, False),
    ("cuda", torch.float32, 2, None, False, False),
], ids=["matern52", "matern32_d7", "sqexp_d1", "ardse_alias_d31", "cpu",
        "float64", "float16", "matmul_form_d32", "matmul_form_d40",
        "requires_grad", "unknown_covariance"])
def test_route_rule(device, dtype, dim, cov, grad, want):
    kernel = kernels.KERNELS[cov] if cov else (lambda a, b, ls: a @ b.mT)
    assert likelihood.use_unit_cov_kernel(device, dtype, dim, kernel,
                                          grad) is want


@pytest.mark.parametrize("cov", COVS)
@pytest.mark.parametrize("k,n,d,n_real", [(3, 96, 2, 90), (2, 64, 7, 41),
                                          (2, 40, 1, 40)],
                         ids=["d2", "d7_ragged", "d1_all_real"])
def test_cpu_route_equals_the_assembly_before_the_kernel(cov, k, n, d,
                                                         n_real):
    x, mask, ls = _points(k, n, d, n_real, seed=n)
    kern = kernels.KERNELS[cov]
    launched, counted = dict(assembly.launches), trace.counters()
    got = likelihood.unit_cov_matrix(x, mask, ls, kern)
    assert torch.equal(got, _assembly_as_written_before_the_kernel(
        x, mask, ls, kern))
    assert torch.equal(got, likelihood.unit_cov_matrix_plain(x, mask, ls,
                                                             kern))
    assert int(torch.count_nonzero(got[:, n_real:])) == 0
    assert int(torch.count_nonzero(got[:, :, n_real:])) == 0
    jit = torch.tensor(likelihood._effective_jitter(n), dtype=torch.float32)
    diag = torch.diagonal(got, dim1=-2, dim2=-1)[:, :n_real]
    assert torch.equal(diag, torch.full_like(diag, 1.0) + jit)
    # the CPU launches nothing and counts no plain route of the card
    assert assembly.launches == launched
    assert (trace.counters().get("assembly:plain", 0)
            == counted.get("assembly:plain", 0))


@pytest.mark.parametrize("ls_shape", [(3, 2), (2, 3, 2), (2,)],
                         ids=["lanes", "two_batch_axes", "no_batch_axis"])
def test_kernel_route_hands_the_wrapper_the_scaled_points(monkeypatch,
                                                          ls_shape):
    """With the route forced to the kernel and the wrapper replaced by a
    recorder: the wrapper gets ard_sqdist's x / ls as [K, N, D], the mask,
    the jitter of N and the covariance's kind; M comes back with ls's
    batch axes."""
    x, mask, _ = _points(1, 48, 2, 40, seed=3)
    ls = torch.rand(ls_shape) + 0.5
    seen = {}

    def fake(a, m, jitter, kind):
        seen.update(a=a, m=m, jitter=jitter, kind=kind)
        return torch.zeros(a.shape[0], a.shape[1], a.shape[1])

    monkeypatch.setattr(likelihood, "use_unit_cov_kernel",
                        lambda *args: True)
    monkeypatch.setattr(likelihood.assembly, "unit_cov", fake)
    out = likelihood.unit_cov_matrix(x, mask, ls, kernels.matern32)
    assert tuple(out.shape) == ls_shape[:-1] + (48, 48)
    want = (x / ls.unsqueeze(-2)).reshape(-1, 48, 2)
    assert seen["a"].is_contiguous() and torch.equal(seen["a"], want)
    assert torch.equal(seen["m"], mask)
    assert seen["jitter"] == likelihood._effective_jitter(48)
    assert seen["kind"] == assembly.KINDS.index("Matern32")


# ----------------------------------------------------------- the wrapper
def _good():
    return torch.zeros(2, 16, 3), torch.ones(16, dtype=torch.bool)


@pytest.mark.parametrize("bad", [
    "float64", "not_contiguous", "two_axes", "dim_32", "mask_float",
    "mask_length", "mask_not_contiguous", "kind", "cpu"])
def test_wrapper_rejects_bad_arguments(bad):
    a, mask = _good()
    kind = 0
    if bad == "float64":
        a = a.double()
    elif bad == "not_contiguous":
        a = torch.zeros(2, 3, 16).transpose(1, 2)
    elif bad == "two_axes":
        a = a[0]
    elif bad == "dim_32":
        a = torch.zeros(2, 16, 32)
    elif bad == "mask_float":
        mask = mask.float()
    elif bad == "mask_length":
        mask = mask[:15]
    elif bad == "mask_not_contiguous":
        mask = torch.ones(32, dtype=torch.bool)[::2]
    elif bad == "kind":
        kind = len(assembly.KINDS)
    launched = dict(assembly.launches)
    with pytest.raises(ValueError):
        assembly.unit_cov(a, mask, 1e-6, kind)
    assert assembly.launches == launched


# ------------------------------------------------- the build and tracing
def test_build_carries_the_kernel_source():
    assert os.path.exists(CU)
    sig = build.SOURCES["unit_cov"]["spm_unit_cov"]
    assert len(sig) == 9 and sig[7] is build._F
    src = open(CU).read()
    assert f"MAX_DIM = {assembly.MAX_DIM};" in src
    assert assembly.MAX_DIM == kernels._MATMUL_MIN_DIM - 1
    kinds = re.search(r"enum Kind \{([^}]*)\}", src).group(1)
    assert [s.split("=")[0].strip() for s in kinds.split(",")] == [
        "MATERN52", "MATERN32", "SQUARED_EXP"]
    assert [kernels.KERNELS[c] for c in assembly.KINDS] == [
        kernels.matern52, kernels.matern32, kernels.squared_exp]


@pytest.mark.parametrize("name,value", [
    ("kSqrt5", math.sqrt(5.0)), ("kFiveThirds", 5.0 / 3.0),
    ("kSqrt3", math.sqrt(3.0))])
def test_kernel_constants_are_the_chains_float32_casts(name, value):
    """The chain multiplies float32 tensors by Python scalars, which
    PyTorch casts to float32 first: the kernel's constants are those
    casts."""
    src = open(CU).read()
    lit = re.search(rf"constexpr float {name} = ([^;]+)f;", src).group(1)
    assert np.float32(float.fromhex(lit)) == np.float32(value)
    assert float.fromhex(lit) == float(np.float32(value))
    x = torch.rand(4096) * 10
    assert torch.equal(value * x, float.fromhex(lit) * x)


def test_trace_knows_the_kernel_range_and_counter():
    assert "unit_cov" in trace.KERNEL_RANGES
    assert "unit_cov" in trace.kernel_launches()
    assembly.reset_launches()
    assert trace.kernel_launches()["unit_cov"] == 0
