#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``spearmint_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure (nothing is caught):

  1. device   name, count, ``nvidia-smi`` name and power limit, SM clocks;
  2. build    the CUDA kernels from ``spearmint_tpu_torch/ops/csrc``, one
              ``nvcc`` per source, all at once;
  3. kernels  B1, B2, B3 at every shape the paths below give them: the
              flagship pad [10, 5120, 5120], the pending pad
              [10, 5248, 5248], the chooser's pad [12, 16, 16] with one
              non-PSD lane, and a ragged [3, 1000, 1000] with one non-PSD
              lane; B4a and B4b (the unshifted kernel, on K = M + diag(d)
              assembled in float32) at the same four shapes with the same
              non-PSD lanes; each held
              against its plain PyTorch version and a float64
              ``torch.linalg`` oracle, and timed at [10, 5120, 5120] (CUDA
              events) beside the plain version, the nearest PyTorch
              library calls, the bound and the schedule's own
              device-memory floor; B1 and B4a called twice on the same
              input must give bit-identical ld and q.  Then B1-B3 on the
              flagship's own M-form and B4a on the constraint
              covariance's own form (pad 5120, ls = 1, no noise term),
              against float64.  B5
              (cyclic reduction) at [10, 64, 128, 128] and [3, 8, 16, 16],
              each with a non-PD lane, against its plain version and
              float64 (ld 1e-5, q 1e-4 relative); then on the band
              flagship's own blocks (the reduction of the flagship's M,
              40 blocks of 128 padded to 64), timed beside its plain
              version, the bound, the dense library Cholesky + solve of
              the same [10, 5120, 5120] matrix, the band scan
              (``band_logdet_q``) and the reduction itself;
  4. check    EI and the log-marginal at fixed hyperparameters on a small
              input (n=1000) against float64 dense math;
  5. flagship ``suggest_step`` at n=5000 (pad 5120), d=2, 10 chains, 2000
              candidates, one warm-up and three timed reps, every kernel's
              launch count > 0 and n_ok == 10;
  6. pending  one rep of the async_large preset (64 pending, 100
              fantasies, augmented pad 5248), every kernel launched, finite
              EI, and n_ok equal to the chains less the samples whose
              float32 pending covariance is indefinite (recomputed, beside
              a float64 one that must be positive definite);
  7. constrained  ``suggest_step_constrained`` on the constrained preset
              (n=5000, pad 5120, 10 chains, 2048 candidates, a quarter of
              the points invalid), one warm-up and two timed reps: B1, B2,
              B3 and B4a launched, finite acquisition, and n_ok equal to 10
              less the samples whose value or constraint matrix a float64
              Cholesky of the same float32 matrix finds indefinite; the
              per-stage seconds, and ``torch.profiler`` over one
              suggestion and over one constraint sweep;
  8. band     the flagship shape with band mode on
              (``SuggestConfig(band_joint=True)``), one warm-up and three
              timed reps: n_ok == 10 on every rep, finite EI, B5 and B1
              launched; the per-stage seconds, a ``torch.profiler`` split
              of one rep into the reduction, B5, the ls move's B1 and the
              assemblies, and peak memory; the padded tail of Qᵀ[y, mask]
              exactly 0, and the band lp at the chains' initial state
              within 2e-4 (relative) of float64 dense lp and of B1's lp;
  9. chooser  the port's GPEIOptChooser on Branin over a 300-point grid,
              16 evaluations, seed BRANIN_SEED, best < 3.0; its pads (≤ 28)
              take the small-pad route (the library Cholesky), so no
              kernel launches;
 10. constrained_chooser  the port's GPConstrainedEIChooser on a 40-point
              grid with 12 completions (violations where x0 > 0.5), three
              ``next`` calls by three chooser objects resuming one state
              file: each returns an index or an (acq, x) tuple and n_ok >
              0; at pad 16 no kernel launches (the small-pad route);
 11. band_chooser  GPEIOptChooser(band_joint_min=2048, chains=10,
              mcmc_iters=10, burnin=5) at 2100 completions (pad 2560), one
              ``next``: an index or an (ei, x) tuple, band mode on, B5
              launched and n_ok > 0;
 12. b1_split one B1 call at [10, 5120, 5120] under ``torch.profiler``,
              its device time by kernel name (trailing, diagonal, panel,
              copy).

Every line before the last three is one JSON record, stamped with the
seconds since the script began (``t_s``).  Then come the
``{"kernels": [...]}`` line (each kernel's launches on every path), the
``nvidia-smi`` line, and the final ``{"ok": true, "device": ...}`` line.
Exits non-zero, printing no result, when no CUDA device is present.

    python3 chip_smoke.py --branin-seeds 0,1,2

runs only the build and phase 9, once per seed, and prints one record
each (no result line): the chooser's success rate on the card.  Two more
probes run the build and then only themselves, printing records and no
result line:

    python3 chip_smoke.py --band-precision   # float32 against float64
                                             # band reduction, one lane
    python3 chip_smoke.py --small-pads       # chooser ``next`` at pads
                                             # 256 and 384, three routes
    python3 chip_smoke.py --vs DIR[,DIR...] [--seeds 0,1,2]

times the checkout's blocked Cholesky (``shifted_chol.cu``) against the
one in each DIR, an earlier version or a variant of it, in turns; with
``--seeds``, counts each build's slice evaluations and non-finite lanes
on the flagship and constrained steps (``vs_builds``).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published H100 SXM peaks at 700 W (NVIDIA data sheet): f32 on the CUDA
# cores and HBM3 bandwidth.  TF32 tensor cores are excluded by design.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

FLAGSHIP = dict(n=5000, d=2, chains=10, cands=2000)
# bench.py PRESETS["async_large"]
ASYNC_LARGE = dict(n=5000, d=2, chains=10, cands=2048, n_pending=64,
                   n_fantasies=100, grid_subset=5, lbfgs_iters=10)
# the kernels (wrappers) every suggestion runs; the constrained path adds
# logdet_q (B4a)
FLAGSHIP_PATH = ("shifted_logdet_q", "shifted_factor_logdet_q", "tri_inverse")
# band mode's block width (MCMCConfig.band_block) and the band chooser's
# problem: 2100 completions pad to 2560 = 20 blocks, 32 for cyclic reduction
BAND_BLOCK = 128
BAND_CHOOSER = dict(n=2100, d=2, cands=1000)
# bench.py PRESETS["constrained"], as time_tpu_constrained sets it up
CONSTRAINED = dict(n=5000, d=2, chains=10, cands=2048, grid_subset=5,
                   lbfgs_iters=10, p_invalid=0.25)


T_START = time.perf_counter()


def emit(rec: dict) -> None:
    """Print one record, stamped with the seconds since the script began."""
    print(json.dumps({**rec, "t_s": time.perf_counter() - T_START}),
          flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_problem(n, d, cands, seed=0):
    """bench.py's make_problem, re-created from the same numpy seed."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, d)
    y = np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1] if d > 1 else 1.0)
    y = y + 0.05 * rng.randn(n)
    cand = rng.rand(cands, d)
    return x, y - y.mean(), cand


def cuda_ms(torch, fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` calls, by CUDA events."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def rel(a, b):
    return float(((a.double() - b.double()).abs()
                  / b.double().abs().clamp_min(1e-30)).max())


def absmax(a, b):
    return float((a.double() - b.double()).abs().max())


def wrel(a, b):
    """max |a − b| over max |b| (w = L⁻¹r spans orders of magnitude)."""
    return absmax(a, b) / float(b.double().abs().max())


def well_conditioned(torch, k, n, seed):
    """Synthetic SPD inputs: M = F Fᵀ/8 (rank 8, λmax ≈ n), shift in
    [0.1, 0.4], so cond ≈ n/0.1 and f32 errors stay near n·eps."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((k, n, 8)).astype(np.float32)
    m = np.einsum("knd,kmd->knm", f, f) / 8
    d = rng.uniform(0.1, 0.4, (k, n)).astype(np.float32)
    r = rng.standard_normal((k, n)).astype(np.float32)
    return [torch.tensor(a, device="cuda") for a in (m, d, r)]


def flagship_inputs(torch):
    """The M-form the flagship's sampler factors: the unit Matérn-5/2
    covariance of bench.py's data at pad 5120, per-lane length scales
    0.3..1.2, shift noise/amp2 = 0.0025/0.5 on real rows, 1/amp2 on pads."""
    from spearmint_tpu_torch.core.likelihood import unit_cov_matrix

    n, pad, k = FLAGSHIP["n"], 5120, FLAGSHIP["chains"]
    x, y, _ = make_problem(n, FLAGSHIP["d"], FLAGSHIP["cands"])
    xp = np.zeros((pad, 2), np.float32); xp[:n] = x
    yp = np.zeros(pad, np.float32); yp[:n] = y
    mask = torch.tensor(np.arange(pad) < n, device="cuda")
    ls = torch.linspace(0.3, 1.2, k, device="cuda")[:, None].expand(k, 2)
    m0 = unit_cov_matrix(torch.tensor(xp, device="cuda"), mask,
                         ls.contiguous()).contiguous()
    dshift = torch.where(mask, 0.0025 / 0.5, 1.0 / 0.5).expand(k, pad)
    r = torch.tensor(yp, device="cuda").expand(k, pad)
    return m0, dshift.contiguous(), r.contiguous()


def oracle_factor(torch, m, d, r):
    """float64 ld, q, L, w = L⁻¹r by torch.linalg."""
    a = m.double() + torch.diag_embed(d.double())
    l, info = torch.linalg.cholesky_ex(a)
    w = torch.linalg.solve_triangular(l, r.double()[..., None],
                                      upper=False)[..., 0]
    ld = torch.log(torch.diagonal(l, dim1=-2, dim2=-1)).sum(-1)
    return ld, (w * w).sum(-1), l, w, info


def lp_of(ld, q):
    return -ld - 0.5 * q


# --------------------------------------------------------------- phase 3
# Element-wise tolerances on the well-conditioned synthetic input (f32
# Cholesky at cond ≈ n/0.1 ≤ 5.3e4): L to 1e-4 absolute on O(1) entries,
# w to 5e-4 of its largest entry, ld to 1e-5 and q to 1e-4 relative, X to
# 5e-4 absolute on entries up to ~3.
TOL = {"ld_rel": 1e-5, "q_rel": 1e-4, "L_abs": 1e-4, "w_abs": 5e-4,
       "X_abs": 5e-4}


def hold_case(torch, gk, case, k, n, seed, nan_lane=None):
    """B1, B2 and B3 on one well-conditioned [k, n, n] input, held against
    their plain versions and a float64 oracle at TOL; ``nan_lane`` is
    negated (non-PSD) and must give NaN in its own ld and q only.  Fails
    on a miss; returns each kernel's max absolute error to its plain
    version."""
    m, d, r = well_conditioned(torch, k, n, seed)
    if nan_lane is not None:
        m[nan_lane] = -m[nan_lane]
    ld1, q1 = gk.shifted_logdet_q(m, d, r)
    ld2, q2, l2, w2 = gk.shifted_factor_logdet_q(m, d, r)
    x3 = gk.tri_inverse(l2)
    torch.cuda.synchronize()
    good = torch.tensor([i != nan_lane for i in range(k)], device="cuda")
    nan_ok = (nan_lane is None or all(
        bool(torch.isnan(v[nan_lane])) for v in (ld1, q1, ld2, q2)))
    ld1, q1, ld2, q2, l2, w2, x3 = (v[good] for v in
                                    (ld1, q1, ld2, q2, l2, w2, x3))
    m, d, r = m[good].contiguous(), d[good].contiguous(), r[good].contiguous()
    p_ld, p_q, p_l, p_w = gk.shifted_factor_logdet_q_ref(m, d, r)
    p_x = gk.tri_inverse_ref(l2.contiguous())
    o_ld, o_q, o_l, o_w, info = oracle_factor(torch, m, d, r)
    if int(info.max()) != 0:
        fail(f"{case}: float64 oracle Cholesky failed on the SPD input")
    eye64 = torch.eye(n, dtype=torch.float64, device="cuda")
    o_x = torch.linalg.solve_triangular(o_l, eye64.expand(len(m), -1, -1),
                                        upper=False)
    err = {
        "B1": {"ld_rel_plain": rel(ld1, p_ld), "q_rel_plain": rel(q1, p_q),
               "ld_rel_f64": rel(ld1, o_ld), "q_rel_f64": rel(q1, o_q)},
        "B2": {"L_abs_plain": absmax(l2, p_l), "w_abs_plain": wrel(w2, p_w),
               "L_abs_f64": absmax(l2, o_l), "w_abs_f64": wrel(w2, o_w),
               "ld_rel_plain": rel(ld2, p_ld), "q_rel_plain": rel(q2, p_q),
               "ld_rel_f64": rel(ld2, o_ld), "q_rel_f64": rel(q2, o_q)},
        "B3": {"X_abs_plain": absmax(x3, p_x), "X_abs_f64": absmax(x3, o_x)},
    }
    upper_max = float(torch.triu(x3, 1).abs().max())
    finite = bool(torch.isfinite(l2).all() and torch.isfinite(x3).all())
    emit({"phase": "kernels", "case": case, "shape": [k, n, n],
          "nan_lane": nan_lane, "nan_lane_isolated": nan_ok,
          "other_lanes_finite": finite, "X_upper_max": upper_max,
          "errors": err, "tolerance": TOL})
    misses = [f"{b} {key}={v}" for b, e in err.items() for key, v in e.items()
              if v > TOL[key.split("_")[0] + "_" + key.split("_")[1]]]
    if misses or not nan_ok or not finite or upper_max != 0.0:
        fail(f"{case}: {misses} nan_lane_isolated={nan_ok} "
             f"finite={finite} X_upper_max={upper_max}")
    return {"B1": max(absmax(ld1, p_ld), absmax(q1, p_q)),
            "B2": max(absmax(ld2, p_ld), absmax(q2, p_q), absmax(l2, p_l),
                      absmax(w2, p_w)),
            "B3": absmax(x3, p_x)}


def hold_case_b4(torch, gk, case, k, n, seed, nan_lane=None):
    """B4a and B4b on K = M + diag(d) of ``hold_case``'s input, assembled
    in float32, held against their plain versions and a float64 oracle of
    the same float32 K at hold_case's TOL; the ``nan_lane`` (M negated)
    must give NaN in its own ld and q only.  Fails on a miss; returns
    each kernel's max absolute error to its plain version."""
    m, d, r = well_conditioned(torch, k, n, seed)
    if nan_lane is not None:
        m[nan_lane] = -m[nan_lane]
    kmat = (m + torch.diag_embed(d)).contiguous()
    del m, d
    ld_a, q_a = gk.logdet_q(kmat, r)
    ld_b, q_b, l_b, w_b = gk.factor_logdet_q(kmat, r)
    torch.cuda.synchronize()
    good = torch.tensor([i != nan_lane for i in range(k)], device="cuda")
    nan_ok = (nan_lane is None or all(
        bool(torch.isnan(v[nan_lane])) for v in (ld_a, q_a, ld_b, q_b)))
    ld_a, q_a, ld_b, q_b, l_b, w_b = (v[good] for v in
                                      (ld_a, q_a, ld_b, q_b, l_b, w_b))
    kmat, r = kmat[good].contiguous(), r[good].contiguous()
    p_ld, p_q, p_l, p_w = gk.factor_logdet_q_ref(kmat, r)
    o_ld, o_q, o_l, o_w, info = oracle_factor(torch, kmat, torch.zeros_like(r),
                                              r)
    if int(info.max()) != 0:
        fail(f"{case}: float64 oracle Cholesky failed on the SPD input")
    err = {
        "B4a": {"ld_rel_plain": rel(ld_a, p_ld), "q_rel_plain": rel(q_a, p_q),
                "ld_rel_f64": rel(ld_a, o_ld), "q_rel_f64": rel(q_a, o_q)},
        "B4b": {"L_abs_plain": absmax(l_b, p_l), "w_abs_plain": wrel(w_b, p_w),
                "L_abs_f64": absmax(l_b, o_l), "w_abs_f64": wrel(w_b, o_w),
                "ld_rel_plain": rel(ld_b, p_ld), "q_rel_plain": rel(q_b, p_q),
                "ld_rel_f64": rel(ld_b, o_ld), "q_rel_f64": rel(q_b, o_q)},
    }
    upper_max = float(torch.triu(l_b, 1).abs().max())
    finite = bool(torch.isfinite(l_b).all())
    emit({"phase": "kernels", "case": case + "_unshifted", "shape": [k, n, n],
          "nan_lane": nan_lane, "nan_lane_isolated": nan_ok,
          "other_lanes_finite": finite, "L_upper_max": upper_max,
          "errors": err, "tolerance": TOL})
    misses = [f"{b} {key}={v}" for b, e in err.items() for key, v in e.items()
              if v > TOL[key.split("_")[0] + "_" + key.split("_")[1]]]
    if misses or not nan_ok or not finite or upper_max != 0.0:
        fail(f"{case} (B4): {misses} nan_lane_isolated={nan_ok} "
             f"finite={finite} L_upper_max={upper_max}")
    return {"B4a": max(absmax(ld_a, p_ld), absmax(q_a, p_q)),
            "B4b": max(absmax(ld_b, p_ld), absmax(q_b, p_q),
                       absmax(l_b, p_l), absmax(w_b, p_w))}


def constraint_form_case(torch, gk):
    """B4a on the covariance the constraint GP's ls move factors at the
    preset's start: ``_constraint_cov`` of bench.py's points at pad 5120,
    ls = 1, amp2 = 1, jitter ``_effective_jitter(5000)`` = 6.2e-4 and no
    noise term, every lane alike; r = ten draws from the float64 prior
    (what the latents' ESS proposes).  Reports ld and q against a float64
    factorization of the same float32 K, beside the float32 library
    Cholesky's error and cond(K)·eps; fails unless ld and q are finite and
    within cond(K)·eps/100 of float64 (relative).  cond(K)·eps bounds the
    error of any float32 factorization; the hundredth is what B4a and
    the float32 library Cholesky both met on the H100 (cond ≈ 6.7e6:
    q within 6e-4 and 1.6e-3, against 8e-3)."""
    from spearmint_tpu_torch.core.likelihood import _effective_jitter
    from spearmint_tpu_torch.engine.constrained import _constraint_cov

    n, pad, k = CONSTRAINED["n"], 5120, CONSTRAINED["chains"]
    x, _, _ = make_problem(n, CONSTRAINED["d"], CONSTRAINED["cands"])
    xp = np.zeros((pad, 2), np.float32); xp[:n] = x
    mask = torch.tensor(np.arange(pad) < n, device="cuda")
    one = torch.ones(1, device="cuda")
    k1 = _constraint_cov(torch.tensor(xp, device="cuda"), mask,
                         torch.ones(1, 2, device="cuda"), one)[0]
    l64 = torch.linalg.cholesky(k1.double())
    eig = torch.linalg.eigvalsh(k1.double())
    cond = float(eig[-1] / eig[0])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    r64 = l64 @ torch.randn(pad, k, generator=gen, dtype=torch.float64,
                            device="cuda")
    r = torch.where(mask[:, None], r64, 0.0).T.float().contiguous()
    w = torch.linalg.solve_triangular(l64, r.T.double(), upper=False)
    o_ld = torch.log(torch.diagonal(l64)).sum().expand(k)
    o_q = (w * w).sum(0)
    del l64, w, r64
    kmat = k1.expand(k, pad, pad).contiguous()
    ld, q = gk.logdet_q(kmat, r)
    p_ld, p_q = gk.logdet_q_ref(kmat, r)
    lib_l, lib_info = torch.linalg.cholesky_ex(k1)
    lib_w = torch.linalg.solve_triangular(lib_l, r.T, upper=False)
    lib_ld = torch.log(torch.diagonal(lib_l)).sum().expand(k)
    lib_q = (lib_w * lib_w).sum(0)
    eps = float(torch.finfo(torch.float32).eps)
    tol = cond * eps / 100.0
    err = {"ld_rel_f64": rel(ld, o_ld), "q_rel_f64": rel(q, o_q),
           "ld_rel_plain": rel(ld, p_ld), "q_rel_plain": rel(q, p_q),
           "library_ld_rel_f64": rel(lib_ld, o_ld),
           "library_q_rel_f64": rel(lib_q, o_q),
           "library_info": int(lib_info)}
    emit({"phase": "kernels", "case": "constraint_cov_form",
          "shape": [k, pad, pad], "jitter": _effective_jitter(n),
          "cond": cond, "cond_eps": cond * eps, "eig_min": float(eig[0]),
          "eig_max": float(eig[-1]), "q_f64": float(o_q[0]),
          "ld_f64": float(o_ld[0]), "errors": err,
          "tolerance": {"ld_rel_f64": tol, "q_rel_f64": tol}})
    finite = bool(torch.isfinite(ld).all() and torch.isfinite(q).all())
    if not finite or err["ld_rel_f64"] > tol or err["q_rel_f64"] > tol:
        fail(f"constraint covariance form: finite={finite} {err} tol={tol}")


# B5 tolerances on the synthetic input (tests/test_band.py:212-220: SPD
# diagonal blocks with a 10·I floor, couplings 0.3·N(0, 1)): ld 1e-5 and q
# 1e-4 relative, the JAX test's own for the Pallas kernel against XLA.
B5_TOL = {"ld_rel": 1e-5, "q_rel": 1e-4}


def cr_synthetic(torch, k, m, b, seed, nan_lane=None):
    """tests/test_band.py:212-220's input at [k, m, b, b], assembled on the
    card, with block 2 of ``nan_lane`` negated (non-PD)."""
    from spearmint_tpu_torch.ops import band

    rng = np.random.RandomState(seed)
    base = torch.tensor(rng.randn(k, m, b, 2 * b).astype(np.float32),
                        device="cuda")
    d = base @ base.mT + 10 * torch.eye(b, device="cuda")
    del base
    s = torch.tensor((0.3 * rng.randn(k, m, b, b)).astype(np.float32),
                     device="cuda")
    s[:, -1] = 0.0
    amp2 = torch.tensor(rng.uniform(0.5, 1.5, k).astype(np.float32),
                        device="cuda")
    dadd = torch.tensor(rng.uniform(0.01, 0.1, (k, m * b)).astype(
        np.float32), device="cuda")
    r = torch.tensor(rng.randn(k, m * b).astype(np.float32), device="cuda")
    a, bb = band._cr_assemble(d, s, amp2, dadd)
    if nan_lane is not None:
        a[nan_lane, 2] = -a[nan_lane, 2]
    return a, bb, r


def block_tridiagonal(torch, a, bb, m, dtype):
    """The dense [K, m·b, m·b] matrix of the first m blocks of (a, bb)."""
    k, _, b, _ = a.shape
    kd = torch.zeros(k, m * b, m * b, dtype=dtype, device="cuda")
    for i in range(m):
        kd[:, i*b:(i+1)*b, i*b:(i+1)*b] = a[:, i].to(dtype)
        if i + 1 < m:
            kd[:, (i+1)*b:(i+2)*b, i*b:(i+1)*b] = bb[:, i].to(dtype)
            kd[:, i*b:(i+1)*b, (i+1)*b:(i+2)*b] = bb[:, i].to(dtype).mT
    return kd


def dense_logdet_q(torch, kd, r):
    """(ld, q, info) of dense K and r by ``cholesky_ex`` + a forward solve."""
    l, info = torch.linalg.cholesky_ex(kd)
    w = torch.linalg.solve_triangular(l, r[..., None], upper=False)[..., 0]
    return (torch.log(torch.diagonal(l, dim1=-2, dim2=-1)).sum(-1),
            (w * w).sum(-1), info)


def hold_case_b5(torch, band, case, k, m, b, seed, nan_lane):
    """B5 on the synthetic input against its plain version and float64
    (dense Cholesky of the whole block-tridiagonal matrix) at B5_TOL; the
    ``nan_lane`` must give NaN in its own ld and q only.  Returns the max
    absolute error to the plain version."""
    a, bb, r = cr_synthetic(torch, k, m, b, seed, nan_lane)
    ld, q = band.cr_logdet_q(a, bb, r)
    torch.cuda.synchronize()
    p_ld, p_q = band.cr_logdet_q_ref(a, bb, r)
    nan_ok = bool(torch.isnan(ld[nan_lane]) and torch.isnan(q[nan_lane]))
    good = torch.tensor([i != nan_lane for i in range(k)], device="cuda")
    ld, q, p_ld, p_q = (v[good] for v in (ld, q, p_ld, p_q))
    a, bb, r = a[good], bb[good], r[good]
    o_ld, o_q, info = dense_logdet_q(
        torch, block_tridiagonal(torch, a, bb, m, torch.float64), r.double())
    if int(info.max()) != 0:
        fail(f"{case}: float64 Cholesky failed on the SPD input")
    err = {"ld_rel_plain": rel(ld, p_ld), "q_rel_plain": rel(q, p_q),
           "ld_rel_f64": rel(ld, o_ld), "q_rel_f64": rel(q, o_q)}
    finite = bool(torch.isfinite(ld).all() and torch.isfinite(q).all())
    emit({"phase": "kernels", "case": case, "kernel": "B5",
          "shape": [k, m, b, b], "nan_lane": nan_lane,
          "nan_lane_isolated": nan_ok, "other_lanes_finite": finite,
          "errors": err, "tolerance": B5_TOL})
    misses = [f"{key}={v}" for key, v in err.items()
              if v > B5_TOL[key.split("_")[0] + "_rel"]]
    if misses or not nan_ok or not finite:
        fail(f"{case} (B5): {misses} nan_lane_isolated={nan_ok} "
             f"finite={finite}")
    return max(absmax(ld, p_ld), absmax(q, p_q))


def band_flagship_blocks(torch):
    """B5's inputs on the band flagship's main path: bench.py's data at pad
    5120 with flagship_inputs' per-lane length scales (0.3..1.2), reduced
    by ``band_reduce`` (M built and reduced in float64, 40 blocks of 128;
    timed by CUDA events over two runs), padded to 64 with inert blocks and
    assembled at amp2 0.5, noise 0.0025, mean 0 (flagship_inputs' shift)."""
    from spearmint_tpu_torch.core.kernels import matern52
    from spearmint_tpu_torch.ops import band

    k = FLAGSHIP["chains"]
    xp, yp, mask = padded_problem(torch, FLAGSHIP["n"], FLAGSHIP["d"],
                                  FLAGSHIP["cands"])[:3]
    n, pad = FLAGSHIP["n"], len(yp)
    x, y = torch.tensor(xp, device="cuda"), torch.tensor(yp, device="cuda")
    mask = torch.tensor(mask, device="cuda")
    ls = torch.linspace(0.3, 1.2, k, device="cuda")[:, None].expand(k, 2)
    reduce_ms = []
    for _ in range(2):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        d, s, uy, um = band.band_reduce(x, y, mask, ls.contiguous(),
                                        matern52, BAND_BLOCK)
        e1.record()
        torch.cuda.synchronize()
        reduce_ms.append(e0.elapsed_time(e1))
    nb = pad // BAND_BLOCK
    mb = 1 << (nb - 1).bit_length()
    ext = (mb - nb) * BAND_BLOCK
    pad_blocks = (0, 0, 0, 0, 0, mb - nb)
    amp2 = torch.full((k,), 0.5, device="cuda")
    dadd = torch.where(mask, 0.0025, 1.0).expand(k, pad).contiguous()
    a, bb = band._cr_assemble(
        torch.nn.functional.pad(d, pad_blocks),
        torch.nn.functional.pad(s, pad_blocks), amp2,
        torch.nn.functional.pad(dadd, (0, ext), value=1.0))
    r = torch.nn.functional.pad(uy, (0, ext)).contiguous()
    tail = torch.cat([uy[:, n:], um[:, n:]], 1)
    return dict(d=d, s=s, amp2=amp2, dadd=dadd, resid=uy.contiguous(), a=a,
                bb=bb, r=r, nb=nb, reduce_ms=reduce_ms,
                tail_max=float(tail.abs().max()))


def b5_bound(k, nb, m, b):
    """(bound ms, what bounds it, the schedule's flops) of B5 on [k, m, b, b]
    whose first nb blocks are real (the rest inert identity padding).

    The bound is the function's least work: a sequential block Cholesky of
    the nb real blocks — per block a b×b Cholesky (b³/3) and the forward
    solve of r (b²), per coupling one b×b triangular solve (b³), one
    symmetric update (b³, each product counted once) and the update of r
    (2b²) — and its bytes: a, bb and r read once, ld and q written.  The
    schedule's own count, cyclic reduction over all m blocks (per
    eliminated block b³/3 + (2b+1)b² for the factor and solve, 6b³ + 4b²
    for the products, the symmetric ones in full; the last block b³/3 +
    b²), is returned beside it as the algorithm's work."""
    flop = k * (nb * (b ** 3 / 3 + b * b) + (nb - 1) * (2 * b ** 3
                                                         + 2 * b * b))
    cr_flop = k * ((m - 1) * (b ** 3 / 3 + (2 * b + 1) * b * b + 6 * b ** 3
                              + 4 * b * b) + b ** 3 / 3 + b * b)
    nbytes = 4.0 * (2 * k * m * b * b + k * m * b + 2 * k)
    t_op, t_b = flop / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_op, t_b), ("operations" if t_op >= t_b else "bytes"),
            cr_flop)


def check_b5(torch):
    """B5 held at the synthetic shapes, then on the band flagship's own
    blocks: held at the level the sampler reads (lp = −ld − q/2, relative
    2e-4 of float64 and of its plain version: cond ≈ 3e5 there) and timed
    beside its plain version, the dense library route on the same
    [10, 5120, 5120] matrix, the band scan and the bound."""
    from spearmint_tpu_torch.ops import band

    max_abs = hold_case_b5(torch, band, "cr_synthetic_flagship_shape",
                           10, 64, 128, seed=0, nan_lane=3)
    hold_case_b5(torch, band, "cr_synthetic_small", 3, 8, 16, seed=1,
                 nan_lane=1)

    fb = band_flagship_blocks(torch)
    a, bb, r = fb["a"], fb["bb"], fb["r"]
    k, m, b, _ = a.shape
    ld, q = band.cr_logdet_q(a, bb, r)
    p_ld, p_q = band.cr_logdet_q_ref(a, bb, r)
    kd = block_tridiagonal(torch, a, bb, fb["nb"], torch.float32)
    rd = r[:, :fb["nb"] * b].contiguous()
    o_ld, o_q, info = dense_logdet_q(torch, kd.double(), rd.double())
    lib = lambda: dense_logdet_q(torch, kd, rd)  # noqa: E731
    l_ld, l_q, l_info = lib()
    err = {"lp_rel_plain": rel(lp_of(ld, q), lp_of(p_ld, p_q)),
           "lp_rel_f64": rel(lp_of(ld, q), lp_of(o_ld, o_q)),
           "library_lp_rel_f64": rel(lp_of(l_ld, l_q), lp_of(o_ld, o_q)),
           "ld_rel_f64": rel(ld, o_ld), "q_rel_f64": rel(q, o_q),
           "oracle_info_max": int(info.max()),
           "library_info_max": int(l_info.max())}
    bnd, by, cr_flop = b5_bound(k, fb["nb"], m, b)
    rec = dict(max_abs_err=max_abs,
               ms=cuda_ms(torch, lambda: band.cr_logdet_q(a, bb, r), 20),
               plain_ms=cuda_ms(torch, lambda: band.cr_logdet_q_ref(a, bb, r),
                                1),
               bound_ms=bnd, bound_by=by,
               library_ms=cuda_ms(torch, lib, 3))
    scan_ms = cuda_ms(torch, lambda: band.band_logdet_q(
        fb["d"], fb["s"], fb["amp2"], fb["dadd"], fb["resid"]), 3)
    emit({"phase": "kernels", "case": "band_flagship_blocks", "kernel": "B5",
          "shape": [k, m, b, b], "real_blocks": fb["nb"],
          "errors": err, "tolerance": {"lp_rel": 2e-4},
          "band_reduce_ms": fb["reduce_ms"], "band_scan_ms": scan_ms,
          "serial_floor": f"{int(math.log2(m)) + 1} dependent {b}-column "
                          "Choleskys",
          "algorithm_flop": cr_flop,
          "algorithm_ms_at_peak": 1e3 * cr_flop / PEAK_F32_FLOPS,
          "times": rec,
          "padded_tail_max": fb["tail_max"]})
    if (max(err["lp_rel_plain"], err["lp_rel_f64"]) > 2e-4
            or err["oracle_info_max"] != 0 or fb["tail_max"] != 0.0):
        fail(f"band flagship blocks: {err} tail={fb['tail_max']}")
    return rec


def schedule_bytes(k, n, panel, tile):
    """Bytes that spm_shifted_chol's schedule moves through device memory
    at [k, n, n] when every launch reads and writes its own tiles once
    (operands that later tiles of the same launch read again are taken to
    hit L2): the copy of M (read and written), per tile step the diagonal
    tile (read; L and L⁻¹ written) and the panel below (read and written),
    in a panel wider than the tile its next columns (read and written),
    and per panel the lower trailing tiles (read and written)."""
    floats = 2 * n * n
    for k0 in range(0, n, panel):
        k1 = min(k0 + panel, n)
        for s0 in range(k0, k1, tile):
            s1 = min(s0 + tile, n)
            floats += 3 * tile * tile + 2 * (n - s1) * tile
            if s1 < k1:
                floats += 2 * (n - s1) * tile
        m = -(-(n - k1) // tile)
        floats += 2 * m * (m + 1) // 2 * tile * tile
    return 4.0 * k * floats


def trailing_flop(k, n, panel, tile):
    """Flops of the trailing launches as scheduled: every tile of each
    update is a full tile x tile x depth product (2 flops an FMA), and in
    a panel wider than the tile the next columns' updates at depth tile."""
    flop = 0
    for k0 in range(0, n, panel):
        k1 = min(k0 + panel, n)
        for s0 in range(k0, k1 - tile, tile):
            flop += -(-(n - s0 - tile) // tile) * tile ** 3
        m = -(-(n - k1) // tile)
        flop += m * (m + 1) // 2 * tile * tile * (k1 - k0)
    return 2.0 * k * flop


def device_ms_by_kernel(torch, fn):
    """Device milliseconds of one call of ``fn`` by kernel name (template
    arguments dropped), and the count of each; ``ProfilerStep*`` is the
    recorded call's span, not a kernel.  The profiler records the second
    of two calls: a session's first events can be lost when earlier
    sessions ran in the process, so the first call is its warm-up step."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        fn()
        torch.cuda.synchronize()
    ms, count = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            hit = re.search(r"(\w+_kernel)", e.name)
            name = hit.group(1) if hit else e.name.split(" (")[0]
            ms[name] = ms.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
            count[name] = count.get(name, 0) + 1
    return {k: [v, count[k]] for k, v in sorted(ms.items(),
                                                key=lambda kv: -kv[1])}


def b1_split(torch, gk, rec):
    """One B1 call at [10, 5120, 5120] under ``torch.profiler``, its device
    time by kernel name beside the call's time and bound from ``rec`` (the
    kernel_times record), the schedule's own device-memory floor and the
    trailing launches' flops.  Run after the paths, so that none of their
    timed reps follows a first profiler session."""
    k, n = FLAGSHIP["chains"], 5120
    m, d, r = well_conditioned(torch, k, n, seed=0)
    emit({"phase": "b1_split", "shape": [k, n, n],
          "panel": gk.CHOL_PANEL, "tile": gk.CHOL_TILE,
          "device_ms_count": device_ms_by_kernel(
              torch, lambda: gk.shifted_logdet_q(m, d, r)),
          "ms": rec["ms"], "bound_ms": rec["bound_ms"],
          "schedule_bytes_ms": 1e3 * schedule_bytes(
              k, n, gk.CHOL_PANEL, gk.CHOL_TILE) / PEAK_BYTES,
          "trailing_flop": trailing_flop(k, n, gk.CHOL_PANEL, gk.CHOL_TILE)})


def check_reproducible(torch, gk, m, d, r, kmat):
    """B1 and B4a twice on the same input: ld and q bit for bit equal."""
    same = {}
    for name, fn in (("B1", lambda: gk.shifted_logdet_q(m, d, r)),
                     ("B4a", lambda: gk.logdet_q(kmat, r))):
        (ld1, q1), (ld2, q2) = fn(), fn()
        same[name] = bool(torch.equal(ld1, ld2) and torch.equal(q1, q2))
    emit({"phase": "kernels", "case": "bitwise_reproducible",
          "shape": list(m.shape), "equal": same})
    if not all(same.values()):
        fail(f"ld and q differ between two calls: {same}")


def check_kernels(torch, gk):
    """B1-B3 against plain versions and float64 at every shape the main
    paths give them, and timed at the flagship shape; returns per-kernel
    records (without launch counts) for the kernels line."""
    records = {}

    # (a) the flagship pad, then the pending flagship's augmented pad, the
    # chooser loop's pad 16 (one tile below a panel) with a non-PSD lane,
    # and a ragged width with a non-PSD lane
    max_abs = hold_case(torch, gk, "flagship_shape_well_conditioned",
                        10, 5120, seed=0)
    max_abs.update(hold_case_b4(torch, gk, "flagship_shape_well_conditioned",
                                10, 5120, seed=0))
    for case, k, n, seed, nan_lane in (
            ("pending_pad_well_conditioned", 10, 5248, 2, None),
            ("chooser_pad_nan_lane", 12, 16, 3, 5),
            ("ragged_nan_lane", 3, 1000, 1, 0)):
        hold_case(torch, gk, case, k, n, seed, nan_lane)
        hold_case_b4(torch, gk, case, k, n, seed, nan_lane)

    # timing at the flagship shape: kernel, plain version, library calls
    n, k = 5120, 10
    m, d, r = well_conditioned(torch, k, n, seed=0)
    l2 = gk.shifted_factor_logdet_q(m, d, r)[2]
    flop = k * n ** 3 / 3.0
    bytes_b1 = 4.0 * (k * n * n + 2 * k * n + 2 * k)
    bytes_b2 = 4.0 * (2 * k * n * n + 3 * k * n + 2 * k)
    bytes_b3 = 4.0 * (2 * k * n * n)
    bytes_b4a = 4.0 * (k * n * n + k * n + 2 * k)
    bytes_b4b = 4.0 * (2 * k * n * n + 2 * k * n + 2 * k)
    kmat = (m + torch.diag_embed(d)).contiguous()

    def bound(b):
        t_op, t_b = flop / PEAK_F32_FLOPS, b / PEAK_BYTES
        return 1e3 * max(t_op, t_b), ("operations" if t_op >= t_b
                                      else "bytes")

    def lib_factor():
        l, _ = torch.linalg.cholesky_ex(m + torch.diag_embed(d))
        w = torch.linalg.solve_triangular(l, r[..., None], upper=False)
        return torch.log(torch.diagonal(l, dim1=-2, dim2=-1)).sum(-1), \
            (w * w).sum((-2, -1)), l, w

    def lib_factor_k():
        l, _ = torch.linalg.cholesky_ex(kmat)
        w = torch.linalg.solve_triangular(l, r[..., None], upper=False)
        return torch.log(torch.diagonal(l, dim1=-2, dim2=-1)).sum(-1), \
            (w * w).sum((-2, -1)), l, w

    eye = torch.eye(n, device="cuda").expand(k, -1, -1)
    t = {
        "B1": (cuda_ms(torch, lambda: gk.shifted_logdet_q(m, d, r), 3),
               cuda_ms(torch, lambda: gk.shifted_logdet_q_ref(m, d, r), 1),
               cuda_ms(torch, lib_factor, 3), bound(bytes_b1)),
        "B2": (cuda_ms(torch, lambda: gk.shifted_factor_logdet_q(m, d, r), 3),
               cuda_ms(torch, lambda: gk.shifted_factor_logdet_q_ref(m, d, r),
                       1),
               cuda_ms(torch, lib_factor, 3), bound(bytes_b2)),
        "B3": (cuda_ms(torch, lambda: gk.tri_inverse(l2), 3),
               cuda_ms(torch, lambda: gk.tri_inverse_ref(l2), 1),
               cuda_ms(torch, lambda: torch.linalg.solve_triangular(
                   l2, eye, upper=False), 3), bound(bytes_b3)),
        "B4a": (cuda_ms(torch, lambda: gk.logdet_q(kmat, r), 3),
                cuda_ms(torch, lambda: gk.logdet_q_ref(kmat, r), 1),
                cuda_ms(torch, lib_factor_k, 3), bound(bytes_b4a)),
        "B4b": (cuda_ms(torch, lambda: gk.factor_logdet_q(kmat, r), 3),
                cuda_ms(torch, lambda: gk.factor_logdet_q_ref(kmat, r), 1),
                cuda_ms(torch, lib_factor_k, 3), bound(bytes_b4b)),
    }
    sched_ms = 1e3 * schedule_bytes(k, n, gk.CHOL_PANEL,
                                    gk.CHOL_TILE) / PEAK_BYTES
    for name, (ms, plain_ms, lib_ms, (bnd, by)) in t.items():
        records[name] = dict(max_abs_err=max_abs[name], ms=ms,
                             plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                             library_ms=lib_ms)
    # the schedule's floor is computed, not measured: it stays out of the
    # records that go into the kernels line
    emit({"phase": "kernel_times", "shape": [k, n, n], "times": records,
          "schedule_bytes_ms_B1_to_B4b": sched_ms})
    check_reproducible(torch, gk, m, d, r, kmat)
    del m, d, r, l2, eye, kmat

    # (b) the flagship's own M-form (cond ≈ 1e6): held at the level the
    # sampler reads, lp = −ld − q/2, relative 1e-3 (the JAX package's TPU
    # smoke criterion against float64, tests/test_tpu_smoke.py)
    m, d, r = flagship_inputs(torch)
    ld1, q1 = gk.shifted_logdet_q(m, d, r)
    ld2, q2, l2, _ = gk.shifted_factor_logdet_q(m, d, r)
    x3 = gk.tri_inverse(l2)
    torch.cuda.synchronize()
    p_ld, p_q = gk.shifted_logdet_q_ref(m, d, r)
    o_ld, o_q, o_l, _, info = oracle_factor(torch, m, d, r)
    lp_k, lp_p, lp_o = lp_of(ld1, q1), lp_of(p_ld, p_q), lp_of(o_ld, o_q)
    # L̃⁻¹ against the float64 inverse of the same f32 factor, relative to
    # its largest entry (its entries reach 1/√shift ≈ 14)
    eye64 = torch.eye(5120, dtype=torch.float64, device="cuda")
    x_o = torch.linalg.solve_triangular(l2.double(), eye64.expand(10, -1, -1),
                                        upper=False)
    err = {"lp_rel_plain": rel(lp_k, lp_p), "lp_rel_f64": rel(lp_k, lp_o),
           "lp2_rel_f64": rel(lp_of(ld2, q2), lp_o),
           "L_abs_f64": absmax(l2, o_l),
           "X_rel_to_max": absmax(x3, x_o) / float(x_o.abs().max()),
           "oracle_info_max": int(info.max())}
    emit({"phase": "kernels", "case": "flagship_M_form",
          "shape": [10, 5120, 5120], "errors": err,
          "tolerance": {"lp_rel": 1e-3, "X_rel_to_max": 1e-3}})
    if max(err["lp_rel_plain"], err["lp_rel_f64"], err["lp2_rel_f64"]) > 1e-3:
        fail(f"flagship M-form lp {err}")
    if err["X_rel_to_max"] > 1e-3:
        fail(f"flagship M-form X {err}")
    del m, d, r, l2, x3, o_l, x_o
    constraint_form_case(torch, gk)
    records["B5"] = check_b5(torch)
    return records


# --------------------------------------------------------------- phase 4
def check_small_input(torch):
    """EI and log-marginal at fixed hypers (n=1000, pad 1024) against
    float64 dense math — the pipeline around the kernels."""
    from spearmint_tpu_torch.acquire import ei as ei_mod
    from spearmint_tpu_torch.core.kernels import matern52
    from spearmint_tpu_torch.core.likelihood import GPHypers, log_marginal

    n, pad = 1000, 1024
    x, y, cand = make_problem(n, 2, 256, seed=3)
    xp = np.zeros((pad, 2), np.float32); xp[:n] = x
    yp = np.zeros(pad, np.float32); yp[:n] = y
    dev = "cuda"
    xt, yt = torch.tensor(xp, device=dev), torch.tensor(yp, device=dev)
    mt = torch.tensor(np.arange(pad) < n, device=dev)
    ct = torch.tensor(cand, dtype=torch.float32, device=dev)
    h = GPHypers(torch.tensor([0.0, 0.1], device=dev),
                 torch.tensor([1.0, 1.5], device=dev),
                 torch.tensor([1e-3, 1e-2], device=dev),
                 torch.tensor([[0.5, 0.8], [0.6, 0.9]], device=dev))
    lp = log_marginal(xt, yt, mt, h)
    cache = ei_mod.make_cache(xt, yt, mt, h, with_inverse=True)
    mu, var = ei_mod.posterior_from_cache(cache, xt, mt, ct)
    ei = ei_mod.ei_from_cache(cache, xt, mt, ct)

    # float64 dense reference on the unpadded data
    xd = torch.tensor(x, dtype=torch.float64, device=dev)
    yd = torch.tensor(y, dtype=torch.float64, device=dev)
    cd = torch.tensor(cand, dtype=torch.float64, device=dev)
    hd = GPHypers(*(a.double() for a in h))
    k = (hd.amp2[:, None, None] * (matern52(xd, xd, hd.ls)
                                   + 1e-6 * torch.eye(n, dtype=torch.float64,
                                                      device=dev))
         + hd.noise[:, None, None] * torch.eye(n, dtype=torch.float64,
                                               device=dev))
    l = torch.linalg.cholesky(k)
    res = (yd - hd.mean[:, None])[..., None]
    w = torch.linalg.solve_triangular(l, res, upper=False)
    lp0 = (-torch.log(torch.diagonal(l, dim1=-2, dim2=-1)).sum(-1)
           - 0.5 * (w * w).sum((-2, -1)))
    kx = hd.amp2[:, None, None] * matern52(xd, cd, hd.ls)
    alpha = torch.cholesky_solve(res, l)
    mu0 = hd.mean[:, None] + (kx.mT @ alpha)[..., 0]
    beta = torch.linalg.solve_triangular(l, kx, upper=False)
    var0 = hd.amp2[:, None] * (1 + 1e-6) - (beta * beta).sum(-2)
    err = {"lp_rel": rel(lp, lp0),
           "mu_abs_rel_max": absmax(mu, mu0) / float(mu0.abs().max()),
           "var_abs_rel_max": absmax(var, var0) / float(var0.abs().max()),
           "ei_finite": bool(torch.isfinite(ei).all())}
    # tolerances of tests/test_tpu_smoke.py (TPU vs float64 golden)
    emit({"phase": "small_input_check", "n": n, "errors": err,
          "tolerance": {"lp_rel": 1e-3, "mu": 5e-3, "var": 5e-3}})
    if (err["lp_rel"] > 1e-3 or err["mu_abs_rel_max"] > 5e-3
            or err["var_abs_rel_max"] > 5e-3 or not err["ei_finite"]):
        fail(f"small-input check {err}")


# --------------------------------------------------------------- phase 5/6
def padded_problem(torch, n, d, cands, n_pending=0):
    from spearmint_tpu_torch.core.linalg import pad_bucket, pend_pad

    x, y, cand = make_problem(n, d, cands)
    pad = pad_bucket(n)
    xp = np.zeros((pad, d), np.float32); xp[:n] = x
    yp = np.zeros(pad, np.float32); yp[:n] = y
    mask = np.arange(pad) < n
    # bench.py time_tpu's pending layout
    p_pad = pend_pad(pad, n_pending) if n_pending > 0 else 4
    pend = np.random.RandomState(7).rand(p_pad, d).astype(np.float32)
    pend_mask = np.arange(p_pad) < n_pending
    return (xp, yp, mask, pend, pend_mask, cand.astype(np.float32),
            np.ones(cands, bool))


def pending_witness(torch, args, samples):
    """Which samples' pending covariance is indefinite, the count that
    decides n_ok with jobs pending.  The port's own float32 covariance
    (fantasy.pending_posterior, the input of the fantasy Cholesky) is
    recomputed for ``samples``; beside it, the same covariance computed in
    float64 from scratch by torch.linalg.  Per sample: the float32
    Cholesky's info, the float64 Cholesky's info on the same float32
    matrix, both matrices' least eigenvalues, and their largest difference
    over amp2."""
    from spearmint_tpu_torch.acquire.fantasy import pending_posterior
    from spearmint_tpu_torch.core.kernels import matern52
    from spearmint_tpu_torch.core.likelihood import (
        JITTER, GPHypers, cross_cov, unit_cov_matrix,
    )
    from spearmint_tpu_torch.core.linalg import mask_psd_matrix

    xp, yp, mask, pend, pend_mask = (torch.tensor(a, device="cuda")
                                     for a in args[:5])
    _, pk32 = pending_posterior(xp, yp, mask, pend, pend_mask, samples)
    h = GPHypers(*(a.double() for a in samples))
    x64, y64, p64 = xp.double(), yp.double(), pend.double()
    k = h.amp2[:, None, None] * unit_cov_matrix(x64, mask, h.ls)
    k = k + torch.diag_embed(torch.where(mask, h.noise[:, None], 1.0))
    l64 = torch.linalg.cholesky(k)
    del k
    kx = cross_cov(x64, p64, h.amp2, h.ls) * mask[:, None]
    beta = torch.linalg.solve_triangular(l64, kx, upper=False)
    del l64
    eye_p = torch.eye(p64.shape[0], dtype=torch.float64, device="cuda")
    kappa = h.amp2[:, None, None] * (matern52(p64, p64, h.ls)
                                     + JITTER * eye_p)
    pk64 = mask_psd_matrix(kappa - beta.mT @ beta + JITTER * eye_p,
                           pend_mask)
    info32 = torch.linalg.cholesky_ex(pk32).info
    return dict(
        indefinite_f32=[int(i) != 0 for i in info32],
        f64_cholesky_of_f32_info=torch.linalg.cholesky_ex(
            pk32.double()).info.tolist(),
        f64_cholesky_of_f64_info=torch.linalg.cholesky_ex(pk64).info.tolist(),
        eigmin_f32=torch.linalg.eigvalsh(pk32.double())[:, 0].tolist(),
        eigmin_f64=torch.linalg.eigvalsh(pk64)[:, 0].tolist(),
        max_diff_over_amp2=((pk32.double() - pk64).abs().amax((-2, -1))
                            / h.amp2).tolist())


def reset_launches():
    from spearmint_tpu_torch.ops import band, gp_kernels

    gp_kernels.reset_launches()
    band.reset_launches()


def launch_counts():
    from spearmint_tpu_torch.ops import band, gp_kernels

    return {**gp_kernels.launches, **band.launches}


def run_suggest(torch, label, reps, n, d, chains, cands, n_pending=0,
                n_fantasies=10, grid_subset=10, lbfgs_iters=20,
                profile=False, band_joint=False):
    """``reps`` suggestions (the first a warm-up when reps > 1); fails
    unless every rep has finite EI and every kernel was launched.  Without
    pending jobs every rep needs n_ok == chains.  With pending jobs a
    sample whose float32 pending covariance is indefinite has NaN
    fantasies and drops out of the EI average, so n_ok must equal chains
    less the samples ``pending_witness`` finds indefinite, and be ≥ 1;
    and the float64 pending covariance must be positive definite in every
    sample.  In band mode B5 must be launched too.  Then one rep with stage
    timing and, with ``profile``, one under ``torch.profiler`` (in band
    mode split by the calls of BAND_RANGES)."""
    from spearmint_tpu_torch.engine.suggest import (
        SuggestConfig, init_chain_states, suggest_step,
    )

    args = padded_problem(torch, n, d, cands, n_pending)
    xp, yp, mask = args[:3]
    cfg = SuggestConfig(mcmc_iters=1, grid_subset=grid_subset,
                        lbfgs_iters=lbfgs_iters, has_pending=n_pending > 0,
                        n_fantasies=n_fantasies, band_joint=band_joint)
    hypers = init_chain_states(torch.tensor(yp, device="cuda"),
                               torch.tensor(mask, device="cuda"), d, chains)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, oks, rep_samples = [], [], []
    for i in range(reps):
        t0 = time.perf_counter()
        res = suggest_step(gen, hypers, *args, cfg, device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        hypers = res.hypers
        oks.append(int(res.n_ok))
        rep_samples.append(res.samples)
        finite = bool(torch.isfinite(res.ei).all()
                      and torch.isfinite(res.x_opt).all()
                      and torch.isfinite(res.ei_opt))
        if not finite or res.ei.shape != (cands,):
            fail(f"{label} rep {i}: finite={finite} "
                 f"shape={tuple(res.ei.shape)}")
    counts = launch_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    path = FLAGSHIP_PATH + (("cr_logdet_q",) if band_joint else ())
    if min(counts[k] for k in path) <= 0:
        fail(f"{label}: a kernel was never launched: {counts}")
    witness = []
    for i, (n_ok, samples) in enumerate(zip(oks, rep_samples)):
        expected = chains
        if n_pending > 0:
            witness.append(pending_witness(torch, args, samples))
            expected -= sum(witness[-1]["indefinite_f32"])
            if max(witness[-1]["f64_cholesky_of_f64_info"]) != 0:
                fail(f"{label} rep {i}: float64 pending covariance not "
                     f"positive definite: {witness[-1]}")
        if n_ok != expected or n_ok < 1:
            fail(f"{label} rep {i}: n_ok={n_ok}, expected {expected}; "
                 f"{witness}")
    stages = {}
    suggest_step(gen, hypers, *args, cfg, device="cuda", stage_times=stages)
    prof = (profile_step(torch, lambda: suggest_step(
        gen, hypers, *args, cfg, device="cuda"),
        top=16 if band_joint else 8,
        ranges=band_ranges() if band_joint else ()) if profile else None)
    return dict(phase=label, n=n, pad=len(yp), chains=chains, cands=cands,
                band_joint=band_joint,
                n_pending=n_pending, n_fantasies=n_fantasies, reps=reps,
                latency_s=times, median_s=float(np.median(times[-3:])
                                                if reps > 1 else times[0]),
                launches=counts, n_ok=oks, ei_finite=True,
                pending_witness=witness,
                max_memory_allocated=peak_bytes,
                stage_s=stages, profile=prof, x_opt=res.x_opt.tolist(),
                ei_opt=float(res.ei_opt))


def band_ranges():
    """The calls a band-mode suggestion is split by: the band reduction
    (geqrf and GEMMs), B5, the assemblies of its inputs and of M, the dense
    log marginal (B1: the ls move and its re-seed) and its M, the caches."""
    from spearmint_tpu_torch.core import likelihood, linalg
    from spearmint_tpu_torch.ops import band

    return [(band, "reduce_to_band"), (band, "cr_logdet_q"),
            (band, "_cr_assemble"), (band, "unit_cov_matrix"),
            (linalg, "fma_logdet_q"), (likelihood, "unit_cov_matrix"),
            (linalg, "cache_factor")]


def profile_step(torch, fn, top=8, ranges=()):
    """One call of ``fn`` under ``torch.profiler``: its wall time, the
    device time of all its kernels and their share of the wall time (the
    device's busy share; the profiler's own host cost lowers it), and the
    kernels that took most device time, by name.  Each (module, name) of
    ``ranges`` is wrapped in a ``record_function`` for the call, and the
    device span of each (first kernel's start to last kernel's end, summed
    over its calls) is reported with its call count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    saved = []
    for mod, attr in ranges:
        orig = getattr(mod, attr)

        def wrapped(*a, _f=orig, _n=f"{mod.__name__}.{attr}", **kw):
            with record_function(_n):
                return _f(*a, **kw)

        saved.append((mod, attr, orig))
        setattr(mod, attr, wrapped)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)
    names = {f"{mod.__name__}.{attr}" for mod, attr in ranges}
    by_name, count = {}, {}
    for e in prof.events():
        # a range shows on the device as a span over its kernels: not a
        # kernel of its own
        if e.device_type == DeviceType.CUDA and e.name not in names:
            name = e.name[:60]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
            count[name] = count.get(name, 0) + 1
    device_s = sum(by_name.values()) / 1e6
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    split = {}
    for ev in prof.key_averages():
        if ev.key in names:
            dev_us = getattr(ev, "device_time_total", None)
            if dev_us is None:
                dev_us = ev.cuda_time_total
            split[ev.key] = [dev_us / 1e6, ev.count]
    return dict(wall_s=wall, device_s=device_s, busy_share=device_s / wall,
                top_device_s=[[k, v / 1e6, count[k]] for k, v in ranked],
                **({"split_device_span_s_calls": split} if ranges else {}))


# --------------------------------------------------------------- phase 7
def constrained_problem():
    """time_tpu_constrained's set-up: bench.py's make_problem, a quarter
    of the points invalid (numpy RandomState(3)), y = 0 where invalid."""
    from spearmint_tpu_torch.core.linalg import pad_bucket

    n, d, cands = (CONSTRAINED[k] for k in ("n", "d", "cands"))
    x, y, cand = make_problem(n, d, cands)
    valid = np.random.RandomState(3).rand(n) > CONSTRAINED["p_invalid"]
    pad = pad_bucket(n)
    xp = np.zeros((pad, d), np.float32); xp[:n] = x
    yp = np.zeros(pad, np.float32); yp[:n] = np.where(valid, y, 0.0)
    vmask = np.zeros(pad, bool); vmask[:n] = valid
    return (xp, yp, vmask, np.arange(pad) < n, cand.astype(np.float32),
            np.ones(cands, bool))


def constrained_witness(torch, xp, vmask, omask, samples, c_samples):
    """Per sample, the float64 Cholesky info of the very float32 matrices
    the two caches hand kernel B2: the value GP's M + diag(dadd/amp2)
    (dadd = noise on valid rows, 1 on the others) and the constraint GP's
    M + diag(where(observed, 0, 1)/amp2).  A nonzero info is the witness
    that the float32 matrix is indefinite."""
    from spearmint_tpu_torch.core.likelihood import unit_cov_matrix

    x = torch.tensor(xp, device="cuda")
    out = {}
    for fam, mask, ls, amp2, dadd in (
            ("value", vmask, samples.ls, samples.amp2,
             lambda m: torch.where(m, samples.noise[:, None], 1.0)),
            ("constraint", omask, c_samples.ls, c_samples.amp2,
             lambda m: torch.where(m, 0.0, 1.0).expand(len(amp2), -1))):
        m = torch.tensor(mask, device="cuda")
        mat = unit_cov_matrix(x, m, ls) + torch.diag_embed(
            dadd(m) / amp2[:, None])
        out[fam] = torch.linalg.cholesky_ex(mat.double()).info.tolist()
        del mat
    out["indefinite"] = [a != 0 or b != 0 for a, b in zip(out["value"],
                                                         out["constraint"])]
    return out


def run_constrained(torch):
    """The constrained preset: one warm-up and two timed reps, each adopting
    the previous rep's chain states (as bench.py does).  Fails unless the
    acquisition is finite, B1, B2, B3 and B4a were launched, and every
    rep's n_ok equals 10 less the witnessed samples.  Then one rep with
    stage timing, one under ``torch.profiler``, and one constraint sweep
    under ``torch.profiler``."""
    from spearmint_tpu_torch.core.kernels import matern52
    from spearmint_tpu_torch.engine.constrained import (
        ConstraintState, _sample_constraint, suggest_step_constrained,
    )
    from spearmint_tpu_torch.engine.suggest import (
        SuggestConfig, init_chain_states,
    )

    c = CONSTRAINED
    chains, d, cands = c["chains"], c["d"], c["cands"]
    args = constrained_problem()
    xp, yp, vmask, omask = args[:4]
    pad = len(yp)
    hypers = init_chain_states(torch.tensor(yp, device="cuda"),
                               torch.tensor(vmask, device="cuda"), d, chains)
    cons = ConstraintState(torch.ones(chains, d, device="cuda"),
                           torch.ones(chains, device="cuda"),
                           torch.zeros(chains, pad, device="cuda"))
    cfg = SuggestConfig(mcmc_iters=1, grid_subset=c["grid_subset"],
                        lbfgs_iters=c["lbfgs_iters"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def step(stage_times=None):
        return suggest_step_constrained(gen, hypers, cons, *args, cfg,
                                        device="cuda", stage_times=stage_times)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, oks, witness = [], [], []
    for i in range(3):
        t0 = time.perf_counter()
        res = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        hypers, cons = res.hypers, res.constraint
        finite = bool(torch.isfinite(res.acq).all()
                      and torch.isfinite(res.x_opt).all()
                      and torch.isfinite(res.acq_opt))
        if not finite or res.acq.shape != (cands,):
            fail(f"constrained rep {i}: finite={finite} "
                 f"shape={tuple(res.acq.shape)}")
        oks.append(int(res.n_ok))
        witness.append(constrained_witness(torch, xp, vmask, omask,
                                           res.samples, res.c_samples))
    counts = launch_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    if min(counts[k] for k in FLAGSHIP_PATH + ("logdet_q",)) <= 0:
        fail(f"constrained: a kernel of the path was never launched: {counts}")
    for i, (n_ok, w) in enumerate(zip(oks, witness)):
        expected = chains - sum(w["indefinite"])
        if n_ok != expected or n_ok < 1:
            fail(f"constrained rep {i}: n_ok={n_ok}, expected {expected}; {w}")
    stages = {}
    step(stages)
    prof = profile_step(torch, step, top=14)
    z = torch.where(torch.tensor(vmask, device="cuda"), 1.0, -1.0)
    sweep = profile_step(torch, lambda: _sample_constraint(
        gen, cons, torch.tensor(xp, device="cuda"), z,
        torch.tensor(omask, device="cuda"), matern52, cfg.max_ls), top=14)
    return dict(phase="constrained", n=c["n"], pad=pad, chains=chains,
                cands=cands, n_valid=int(vmask.sum()), reps=3,
                latency_s=times, median_s=float(np.median(times[1:])),
                launches=counts, n_ok=oks, acq_finite=True,
                witness=witness, max_memory_allocated=peak_bytes,
                stage_s=stages, profile=prof, constraint_sweep_profile=sweep,
                c_ls=cons.ls.tolist(), c_amp2=cons.amp2.tolist(),
                x_opt=res.x_opt.tolist(), acq_opt=float(res.acq_opt))


# --------------------------------------------------------------- band
def band_state_check(torch):
    """At the band flagship's initial chain state (init_chain_states of
    bench.py's data at pad 5120): the padded tail of Qᵀ[y, mask] from the
    reduction (``band_reduce``) is exactly 0, and the band lp per chain (the factory: the
    reduction and B5) is within 2e-4 relative of float64 dense lp (M and
    the factorization in float64) and of B1's lp (``log_marginal``)."""
    from spearmint_tpu_torch.core.kernels import matern52
    from spearmint_tpu_torch.core.likelihood import (
        log_marginal, unit_cov_matrix,
    )
    from spearmint_tpu_torch.engine.suggest import init_chain_states
    from spearmint_tpu_torch.ops import band

    n, chains = FLAGSHIP["n"], FLAGSHIP["chains"]
    xp, yp, mask = padded_problem(torch, n, FLAGSHIP["d"],
                                  FLAGSHIP["cands"])[:3]
    pad = len(yp)
    x, y = torch.tensor(xp, device="cuda"), torch.tensor(yp, device="cuda")
    m = torch.tensor(mask, device="cuda")
    h = init_chain_states(y, m, FLAGSHIP["d"], chains)
    _, _, uy, um = band.band_reduce(x, y, m, h.ls, matern52, BAND_BLOCK)
    tail_max = float(torch.cat([uy[:, n:], um[:, n:]], 1).abs().max())
    reset_launches()
    lp_band = band.band_marginal_factory(x, y, m, h.ls, matern52,
                                         BAND_BLOCK)(h.mean, h.amp2, h.noise)
    counts = launch_counts()
    lp_b1 = log_marginal(x, y, m, h)
    # float64 at the same pad (the jitter is the pad's): every chain
    # starts at the same state, so one lane
    h64 = [a[:1].double() for a in h]
    k64 = (h64[1][:, None, None] * unit_cov_matrix(x.double(), m, h64[3])
           + torch.diag_embed(torch.where(m, h64[2][:, None], 1.0)))
    l64 = torch.linalg.cholesky(k64)[0]
    w = torch.linalg.solve_triangular(
        l64, torch.where(m, y.double() - h64[0], 0.0)[:, None], upper=False)
    lp64 = float(-torch.log(torch.diagonal(l64)).sum() - 0.5 * (w * w).sum())
    del k64, l64
    err = {"lp_rel_f64": float(((lp_band.double() - lp64).abs()
                                / abs(lp64)).max()),
           "lp_rel_b1": rel(lp_band, lp_b1),
           "b1_lp_rel_f64": float(((lp_b1.double() - lp64).abs()
                                   / abs(lp64)).max())}
    rec = dict(phase="band_state_check", pad=pad, padded_tail_max=tail_max,
               lp_band=lp_band.tolist(), lp_b1=lp_b1.tolist(), lp_f64=lp64,
               errors=err, tolerance={"lp_rel": 2e-4},
               launches=counts)
    emit(rec)
    if (tail_max != 0.0 or max(err["lp_rel_f64"], err["lp_rel_b1"]) > 2e-4
            or counts["cr_logdet_q"] != 1):
        fail(f"band state check: {rec}")


def band_precision_check(torch):
    """``--band-precision``: why ``band_reduce`` works in float64.  One lane
    of the band flagship
    at ls = 1.2 (its largest M), reduced in float32 (``reduce_to_band`` on
    the float32 M) and by ``band_reduce``.  For each: the largest shift of
    T's eigenvalues from M's (float64 ``eigvalsh`` of the dense band
    matrix and of M), T's least eigenvalue, and lp through B5 at amp2 0.4,
    noise 1e-3 (about the initial state) against float64 dense lp.  Fails
    if the float64 reduction's lp is off by more than 2e-4 (relative)."""
    from spearmint_tpu_torch.core.kernels import matern52
    from spearmint_tpu_torch.core.likelihood import unit_cov_matrix
    from spearmint_tpu_torch.ops import band

    n = FLAGSHIP["n"]
    xp, yp, mask = padded_problem(torch, n, FLAGSHIP["d"],
                                  FLAGSHIP["cands"])[:3]
    pad = len(yp)
    x, y = torch.tensor(xp, device="cuda"), torch.tensor(yp, device="cuda")
    m = torch.tensor(mask, device="cuda")
    ls = torch.full((1, 2), 1.2, device="cuda")
    amp2, noise = torch.full((1,), 0.4, device="cuda"), 1e-3
    m64 = unit_cov_matrix(x.double(), m, ls.double())[0]
    eig_m = torch.linalg.eigvalsh(m64)
    k64 = amp2.double() * m64 + torch.diag(torch.where(m, noise, 1.0)
                                           .double())
    lp64 = float(lp_of(*dense_logdet_q(torch, k64, torch.where(
        m, y, 0.0).double())[:2]))
    del k64
    vecs = torch.stack([torch.where(m, y, 0.0), m.float()], -1)[None]
    routes = {"float32": band.reduce_to_band(
        unit_cov_matrix(x, m, ls), vecs.contiguous(), BAND_BLOCK)}
    d, s, uy, um = band.band_reduce(x, y, m, ls, matern52, BAND_BLOCK)
    routes["float64"] = (d, s, torch.stack([uy, um], -1))
    nb = pad // BAND_BLOCK
    mb = 1 << (nb - 1).bit_length()
    ext = (mb - nb) * BAND_BLOCK
    dadd = torch.nn.functional.pad(torch.where(m, noise, 1.0)[None],
                                   (0, ext), value=1.0)
    rec = {"phase": "band_precision", "ls": 1.2, "amp2": 0.4,
           "noise": noise, "lp_f64": lp64,
           "eig_M_least_real": float(eig_m[pad - n])}
    for name, (d, s, vt) in routes.items():
        eig_t = torch.linalg.eigvalsh(block_tridiagonal(
            torch, d, s, nb, torch.float64)[0])
        a, bb = band._cr_assemble(
            torch.nn.functional.pad(d, (0, 0, 0, 0, 0, mb - nb)),
            torch.nn.functional.pad(s, (0, 0, 0, 0, 0, mb - nb)), amp2,
            dadd)
        ld, q = band.cr_logdet_q(a, bb, torch.nn.functional.pad(
            vt[..., 0], (0, ext)).contiguous())
        rec[name] = {"eig_shift_max": float((eig_t - eig_m).abs().max()),
                     "eig_T_least": float(eig_t[0]),
                     "lp": float(lp_of(ld, q)[0]),
                     "lp_rel_f64": abs(float(lp_of(ld, q)[0]) - lp64)
                     / abs(lp64)}
    emit(rec)
    if not rec["float64"]["lp_rel_f64"] <= 2e-4:
        fail(f"band precision: {rec}")


def chooser_next(n, d, cands, options, seed):
    """One ``next`` of a new GPEIOptChooser (``options`` plus device=cuda)
    on bench.py's data with n completions and ``cands`` candidates.
    Returns (what it returned, whether that is valid, its suggest event,
    wall seconds)."""
    from spearmint_tpu_torch.choosers import get_chooser

    x, y, cand = make_problem(n, d, cands, seed=seed)
    grid = np.concatenate([x, cand])
    values = np.concatenate([y, np.full(cands, np.nan)])
    complete = np.arange(n)
    candidates = np.arange(n, n + cands)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as expt:
        chooser = get_chooser("GPEIOptChooser", expt,
                              options + ",device=cuda")
        sel = chooser.next(grid, values, np.zeros(len(grid)), candidates,
                           np.array([], int), complete)
        ev = [e for e in chooser.events.read() if e["kind"] == "suggest"][-1]
    seconds = time.perf_counter() - t0
    if isinstance(sel, tuple):
        out = ["tuple", float(sel[0]), [float(v) for v in sel[1]]]
        ok = bool(np.isfinite(sel[0]) and np.all((sel[1] >= 0)
                                                 & (sel[1] <= 1)))
    else:
        out = ["index", int(sel)]
        ok = isinstance(sel, int) and sel in set(candidates.tolist())
    return out, ok, ev, seconds


def run_band_chooser():
    """One ``next`` of GPEIOptChooser(band_joint_min=2048, chains=10,
    mcmc_iters=10, burnin=5) on bench.py's data at 2100 completions (pad
    2560) and 1000 candidates: an index among the candidates or an (ei, x)
    tuple with x in the unit box, band mode on, B5 launched, n_ok > 0."""
    from spearmint_tpu_torch.core.linalg import pad_bucket

    c = BAND_CHOOSER
    reset_launches()
    out, ok, ev, seconds = chooser_next(
        c["n"], c["d"], c["cands"],
        "band_joint_min=2048,chains=10,mcmc_iters=10,burnin=5", seed=4)
    rec = dict(phase="band_chooser", n=c["n"], pad=pad_bucket(c["n"]),
               returned=out,
               n_ok=ev["n_ok"], band_joint=ev["band_joint"],
               latency_s=ev["latency_s"], seconds=seconds,
               launches=launch_counts())
    emit(rec)
    if (not ok or ev["n_ok"] <= 0 or ev["band_joint"] is not True
            or rec["launches"]["cr_logdet_q"] <= 0):
        fail(f"band chooser: {rec}")
    return rec


def small_pad_times(torch):
    """``--small-pads``: one GPEIOptChooser ``next`` (chains=10,
    mcmc_iters=10, burnin=5, 1000 candidates) at 250 and 380 completions
    (pads 256 and 384, below ``kernel_ok``) by each factorization route such
    a pad could take: the library Cholesky (the port's), the column sweep
    (``gp_kernels.column_cholesky``, the port's CPU route) and the blocked
    kernels B1-B3 (every pad sent to them).  Each route runs twice in a row;
    both wall times are kept, the second without first-call set-up."""
    from spearmint_tpu_torch.core import linalg
    from spearmint_tpu_torch.ops import gp_kernels

    routes = {"library": {},
              "column": {"small_cholesky": gp_kernels.column_cholesky},
              "blocked": {"kernel_ok": lambda n: True}}
    for n in (250, 380):
        for route, patch in routes.items():
            saved = {k: getattr(linalg, k) for k in patch}
            for k, v in patch.items():
                setattr(linalg, k, v)
            try:
                runs = []
                for _ in range(2):
                    reset_launches()
                    out, ok, ev, seconds = chooser_next(
                        n, 2, 1000, "chains=10,mcmc_iters=10,burnin=5",
                        seed=5)
                    runs.append(dict(seconds=seconds, n_ok=ev["n_ok"],
                                     valid=ok, latency_s=ev["latency_s"],
                                     launches=launch_counts()))
            finally:
                for k, v in saved.items():
                    setattr(linalg, k, v)
            emit({"phase": "small_pads", "n": n,
                  "pad": linalg.pad_bucket(n), "route": route, "runs": runs})


# --------------------------------------------------------------- --vs
def build_shifted_chol(srcs):
    """{label: source dir} -> {label: library}: each dir's
    ``shifted_chol.cu`` (beside its ``tile_ops.cuh``) built with the
    package's flags and ``-Xptxas -v``, one ``nvcc`` each, all at once;
    prints each build's ptxas report (registers, stack, spills)."""
    import ctypes

    from spearmint_tpu_torch.ops import build

    out = os.path.join(build.BUILD_ROOT, "vs")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for label, src in srcs.items():
        path = os.path.join(out, f"lib{label}.so")
        procs[label] = (path, subprocess.Popen(
            [build._nvcc(), *build.FLAGS, "-Xptxas", "-v", "-o", path,
             os.path.join(src, "shifted_chol.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"nvcc failed for {label}:\n{log}")
        emit({"phase": "vs_ptxas", "build": label, "source": srcs[label],
              "log": [ln.strip() for ln in log.splitlines() if ln.strip()]})
        lib = ctypes.CDLL(path)
        lib.spm_shifted_chol.argtypes = \
            build.SOURCES["shifted_chol"]["spm_shifted_chol"]
        lib.spm_shifted_chol.restype = ctypes.c_int
        libs[label] = lib
    return libs


def vs_builds(torch, gk, dirs, seeds):
    """``--vs DIR[,DIR...] [--seeds S,...]``: the checkout's
    ``shifted_chol.cu`` against the one in each DIR (an earlier version of
    the kernel, or a variant of it), every build loaded in turn in place of
    the package's.  B1, B2, B4a and B4b timed in turns (a, b, b, a) at
    [10, 5120, 5120], [10, 5248, 5248] and [3, 1000, 1000], each build's
    ld and q (and L) held to the checkout's; one B1 call of each build
    split by kernel name.  With ``--seeds``, per seed and per build (in
    turns): two flagship and two constrained suggestions from the initial
    chain states, each step's B1 and B4a launches (the slice evaluations),
    the lanes whose ld or q came back non-finite, and B4a's lp against a
    float64 factorization of the same matrix (nats, over finite lanes)."""
    from spearmint_tpu_torch.engine.constrained import (
        ConstraintState, suggest_step_constrained,
    )
    from spearmint_tpu_torch.engine.suggest import (
        SuggestConfig, init_chain_states, suggest_step,
    )
    from spearmint_tpu_torch.ops import build

    srcs = {"checkout": build.CSRC,
            **{os.path.basename(os.path.normpath(p)): os.path.abspath(p)
               for p in dirs}}
    libs = build_shifted_chol(srcs)
    names = list(libs)
    order = names + names[::-1]

    def use(label):
        build._loaded["shifted_chol"] = libs[label]

    calls = {"B1": lambda m, d, r, km: gk.shifted_logdet_q(m, d, r),
             "B2": lambda m, d, r, km: gk.shifted_factor_logdet_q(m, d, r),
             "B4a": lambda m, d, r, km: gk.logdet_q(km, r),
             "B4b": lambda m, d, r, km: gk.factor_logdet_q(km, r)}
    for k, n in ((10, 5120), (10, 5248), (3, 1000)):
        m, d, r = well_conditioned(torch, k, n, seed=0)
        km = (m + torch.diag_embed(d)).contiguous()
        for kname, fn in calls.items():
            ms, outs = {v: [] for v in names}, {}
            for v in order:
                use(v)
                outs[v] = fn(m, d, r, km)
                ms[v].append(cuda_ms(torch, lambda: fn(m, d, r, km), 3))
            ref = outs[names[0]]
            agree = {v: {"ld_rel": rel(outs[v][0], ref[0]),
                         "q_rel": rel(outs[v][1], ref[1]),
                         **({"L_abs": absmax(outs[v][2], ref[2])}
                            if len(ref) == 4 else {})}
                     for v in names[1:]}
            emit({"phase": "vs_turns", "kernel": kname, "shape": [k, n, n],
                  "order": order, "ms": ms,
                  "ms_mean": {v: float(np.mean(t)) for v, t in ms.items()},
                  "agree_with_checkout": agree})
        if n == 5120:
            for v in names:
                use(v)
                emit({"phase": "vs_b1_split", "build": v, "shape": [k, n, n],
                      "device_ms_count": device_ms_by_kernel(
                          torch, lambda: gk.shifted_logdet_q(m, d, r))})
        del m, d, r, km, outs
        torch.cuda.empty_cache()

    if not seeds:
        return
    plain_call, nonfinite, lp_err = gk._shifted_chol, [0], []

    def counted(m0, dshift, resid, emit):
        out = plain_call(m0, dshift, resid, emit)
        nonfinite[0] += int((~(torch.isfinite(out[0])
                               & torch.isfinite(out[1]))).sum())
        if dshift is None:   # B4a: its lp against float64, same matrix
            ld, q = oracle_factor(torch, m0, torch.zeros_like(resid),
                                  resid)[:2]
            err = (lp_of(out[0], out[1]).double() - lp_of(ld, q)).abs()
            lp_err.extend(err[torch.isfinite(err)].tolist())
        return out

    gk._shifted_chol = counted
    f, c = FLAGSHIP, CONSTRAINED
    f_args = padded_problem(torch, f["n"], f["d"], f["cands"])
    f_cfg = SuggestConfig(mcmc_iters=1, grid_subset=10, lbfgs_iters=20)
    c_args = constrained_problem()
    c_cfg = SuggestConfig(mcmc_iters=1, grid_subset=c["grid_subset"],
                          lbfgs_iters=c["lbfgs_iters"])
    chains, pad = c["chains"], len(c_args[1])
    for i, seed in enumerate(seeds):
        for v in (names if i % 2 == 0 else names[::-1]):
            use(v)
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed)
            steps = []
            hypers = init_chain_states(
                torch.tensor(f_args[1], device="cuda"),
                torch.tensor(f_args[2], device="cuda"), f["d"], f["chains"])
            for _ in range(2):
                reset_launches()
                nonfinite[0] = 0
                res = suggest_step(gen, hypers, *f_args, f_cfg,
                                   device="cuda")
                hypers = res.hypers
                steps.append({"path": "flagship", "n_ok": int(res.n_ok),
                              **launch_counts(), "nonfinite": nonfinite[0]})
            hypers = init_chain_states(
                torch.tensor(c_args[1], device="cuda"),
                torch.tensor(c_args[2], device="cuda"), c["d"], chains)
            cons = ConstraintState(torch.ones(chains, c["d"], device="cuda"),
                                   torch.ones(chains, device="cuda"),
                                   torch.zeros(chains, pad, device="cuda"))
            for _ in range(2):
                reset_launches()
                nonfinite[0] = 0
                lp_err.clear()
                res = suggest_step_constrained(gen, hypers, cons, *c_args,
                                               c_cfg, device="cuda")
                hypers, cons = res.hypers, res.constraint
                steps.append({"path": "constrained", "n_ok": int(res.n_ok),
                              **launch_counts(), "nonfinite": nonfinite[0],
                              "b4a_lp_err_f64_max": max(lp_err, default=0.0),
                              "b4a_lp_err_f64_median": float(
                                  np.median(lp_err)) if lp_err else 0.0})
            emit({"phase": "vs_paths", "build": v, "seed": seed,
                  "steps": steps})
    gk._shifted_chol = plain_call


# --------------------------------------------------------------- phase 8
def branin_unit(u):
    x = 15.0 * u[0] - 5.0
    y = 15.0 * u[1]
    v = (y - (5.1 / (4 * math.pi ** 2)) * x ** 2 + (5 / math.pi) * x - 6) ** 2
    return v + 10 * (1 - 1 / (8 * math.pi)) * math.cos(x) + 10


# Seed of the chooser loop.  At 16 evaluations a run misses 3.0 from
# about one seed in four (``--branin-seeds`` measures the rate), so the
# seed is fixed; its run on the card is deterministic (every kernel and
# reduction sums in a fixed order).
BRANIN_SEED = 2


def branin_loop(torch, seed):
    """16 Branin evaluations chosen by the port's GPEIOptChooser over a
    300-point numpy grid (the budget of tests/test_e2e_branin.py)."""
    from spearmint_tpu_torch.choosers import get_chooser

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as expt:
        chooser = get_chooser(
            "GPEIOptChooser", expt,
            "mcmc_iters=3,chains=4,burnin=20,grid_subset=4,lbfgs_iters=15,"
            f"seed={seed},device=cuda")
        grid = [p for p in np.random.RandomState(1).rand(300, 2)]
        values = [np.nan] * len(grid)
        for _ in range(16):
            complete = [i for i, v in enumerate(values) if not np.isnan(v)]
            candidates = [i for i, v in enumerate(values) if np.isnan(v)]
            sel = chooser.next(np.array(grid), np.array(values),
                               np.zeros(len(grid)), np.array(candidates),
                               np.array([], int), np.array(complete, int))
            if isinstance(sel, tuple):
                grid.append(np.clip(np.asarray(sel[1]), 0.0, 1.0))
                values.append(np.nan)
                sel = len(grid) - 1
            values[sel] = branin_unit(grid[sel])
        state = os.path.exists(os.path.join(expt,
                                            "GPEIOptChooser_state.npz"))
    done = [v for v in values if not np.isnan(v)]
    return dict(phase="chooser_branin", seed=seed, evaluations=len(done),
                best=float(min(done)), seconds=time.perf_counter() - t0,
                state_file=state)


def run_chooser(torch):
    """The Branin loop; its pads (16 to 28) are below ``kernel_ok``, so the
    gate sends every factorization to the small-pad route and no kernel
    may be launched."""
    reset_launches()
    rec = branin_loop(torch, BRANIN_SEED)
    rec["launches"] = launch_counts()
    emit(rec)
    if rec["evaluations"] != 16 or not rec["best"] < 3.0 \
            or not rec["state_file"]:
        fail(f"chooser loop: {rec}")
    if max(rec["launches"].values()) != 0:
        fail(f"chooser loop: a kernel was launched below pad 512: {rec}")
    return rec


# --------------------------------------------------------------- phase 9
def run_constrained_chooser(torch):
    """Three ``next`` calls of the port's GPConstrainedEIChooser on the
    problem of tests/test_constrained.py (40-point grid, 12 completions,
    violations where x0 > 0.5), each by a new chooser object that resumes
    the state file; each suggestion is evaluated and appended."""
    from spearmint_tpu_torch.choosers import get_chooser

    def objective(u):
        return np.nan if u[0] > 0.5 else 2.0 * u[1]

    rng = np.random.RandomState(1)
    grid = [p for p in rng.rand(40, 2)]
    values = [np.nan] * 40
    done = list(range(12))
    for i in done:
        values[i] = objective(grid[i]) + 0.1 * rng.randn()
    reset_launches()
    t0 = time.perf_counter()
    outs, n_oks = [], []
    with tempfile.TemporaryDirectory() as expt:
        for _ in range(3):
            chooser = get_chooser(
                "GPConstrainedEIChooser", expt,
                "mcmc_iters=4,chains=3,burnin=15,grid_subset=3,"
                "lbfgs_iters=8,seed=0,device=cuda")
            cand = [i for i in range(len(grid)) if i not in done]
            sel = chooser.next(np.array(grid), np.array(values),
                               np.zeros(len(grid)), np.array(cand),
                               np.array([], int), np.array(done))
            n_oks.append([e["n_ok"] for e in chooser.events.read()
                          if e["kind"] == "suggest"][-1])
            if isinstance(sel, tuple):
                outs.append(["tuple", float(sel[0]), list(sel[1])])
                ok = (np.isfinite(sel[0]) and bool(np.all(
                    (sel[1] >= 0) & (sel[1] <= 1))))
                grid.append(np.asarray(sel[1]))
                values.append(np.nan)
                sel = len(grid) - 1
            else:
                outs.append(["index", int(sel)])
                ok = isinstance(sel, int) and sel in cand
            if not ok:
                fail(f"constrained chooser returned {outs[-1]}")
            values[sel] = objective(grid[sel])
            done.append(sel)
        with np.load(os.path.join(
                expt, "GPConstrainedEIChooser_state.npz")) as z:
            keys = sorted(z.files)
    rec = dict(phase="constrained_chooser", calls=outs, n_ok=n_oks,
               launches=launch_counts(), state_keys=keys,
               seconds=time.perf_counter() - t0)
    emit(rec)
    # pad 16 is below kernel_ok: the gate's route launches no kernel
    if max(rec["launches"].values()) != 0 or min(n_oks) <= 0 \
            or "c_ff" not in keys:
        fail(f"constrained chooser: {rec}")
    return rec


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    import spearmint_tpu_torch  # noqa: F401  (sets full-f32 matmuls)
    from spearmint_tpu_torch.ops import build, gp_kernels as gk

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi("name,power.limit")
    emit({"phase": "device", "kind": kind, "count": count,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "clocks_max_sm": nvidia_smi("clocks.max.sm")})

    t0 = time.perf_counter()
    took = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": took})
    if argv[:1] == ["--branin-seeds"]:
        for seed in argv[1].split(","):
            emit(branin_loop(torch, int(seed)))
        return 0
    if argv[:1] == ["--band-precision"]:
        band_precision_check(torch)
        return 0
    if argv[:1] == ["--small-pads"]:
        small_pad_times(torch)
        return 0
    if argv[:1] == ["--vs"]:
        seeds = ([int(s) for s in argv[3].split(",")]
                 if argv[2:3] == ["--seeds"] else [])
        vs_builds(torch, gk, argv[1].split(","), seeds)
        return 0

    records = check_kernels(torch, gk)
    emit({"phase": "clocks_after_kernels",
          "clocks_sm": nvidia_smi("clocks.sm"),
          "power_draw": nvidia_smi("power.draw")})
    check_small_input(torch)

    flag = run_suggest(torch, "flagship", 4, profile=True, **FLAGSHIP)
    emit(flag)
    pend = run_suggest(torch, "pending_async_large", 1, **ASYNC_LARGE)
    emit(pend)
    cons = run_constrained(torch)
    emit(cons)
    band_rec = run_suggest(torch, "band", 4, profile=True,
                           band_joint=True, **FLAGSHIP)
    emit(band_rec)
    band_state_check(torch)
    paths = {"flagship": flag["launches"], "pending": pend["launches"],
             "constrained": cons["launches"], "band": band_rec["launches"],
             "branin_chooser": run_chooser(torch)["launches"],
             "constrained_chooser": run_constrained_chooser(
                 torch)["launches"],
             "band_chooser": run_band_chooser()["launches"]}
    b1_split(torch, gk, records["B1"])

    src = "spearmint_tpu_torch/ops/csrc/"
    pallas = "spearmint_tpu/ops/pallas_gp.py:"
    # id: (wrapper, source, TPU kernel, the path whose run gives launches)
    replaces = {
        "B1": ("shifted_logdet_q", src + "shifted_chol.cu", pallas + "930",
               "flagship"),
        "B2": ("shifted_factor_logdet_q", src + "shifted_chol.cu",
               pallas + "777", "flagship"),
        "B3": ("tri_inverse", src + "tri_inverse.cu", pallas + "816",
               "flagship"),
        "B4a": ("logdet_q", src + "shifted_chol.cu", pallas + "896",
                "constrained"),
        "B4b": ("factor_logdet_q", src + "shifted_chol.cu", pallas + "743",
                None),
        "B5": ("cr_logdet_q", src + "cyclic_reduction.cu",
               "spearmint_tpu/ops/band.py:409", "band"),
    }
    kernels = []
    for key, (name, source, rep, main_path) in replaces.items():
        kernels.append({
            "name": name, "id": key, "route": "cuda", "source": source,
            "replaces": rep,
            "launches": paths[main_path][name] if main_path else 0,
            "main_path": main_path or "none: no path of the port calls "
                                      "B4b (nor of the JAX package)",
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            **records[key]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
