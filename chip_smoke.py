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
              lane, each held against its plain PyTorch version and a
              float64 ``torch.linalg`` oracle; timed at the flagship pad
              (CUDA events) beside the plain version, the nearest PyTorch
              library calls and the bound;
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
  7. chooser  the port's GPEIOptChooser on Branin over a 300-point grid,
              16 evaluations, seed 2, best < 3.0.

Every line before the last three is one JSON record.  Then come the
``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and the final
``{"ok": true, "device": ...}`` line.  Exits non-zero, printing no result,
when no CUDA device is present.

    python3 chip_smoke.py --branin-seeds 0,1,2

runs only the build and phase 7, once per seed, and prints one record
each (no result line): the chooser's success rate on the card.
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


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


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
    for case, k, n, seed, nan_lane in (
            ("pending_pad_well_conditioned", 10, 5248, 2, None),
            ("chooser_pad_nan_lane", 12, 16, 3, 5),
            ("ragged_nan_lane", 3, 1000, 1, 0)):
        hold_case(torch, gk, case, k, n, seed, nan_lane)

    # timing at the flagship shape: kernel, plain version, library calls
    n, k = 5120, 10
    m, d, r = well_conditioned(torch, k, n, seed=0)
    l2 = gk.shifted_factor_logdet_q(m, d, r)[2]
    flop = k * n ** 3 / 3.0
    bytes_b1 = 4.0 * (k * n * n + 2 * k * n + 2 * k)
    bytes_b2 = 4.0 * (2 * k * n * n + 3 * k * n + 2 * k)
    bytes_b3 = 4.0 * (2 * k * n * n)

    def bound(b):
        t_op, t_b = flop / PEAK_F32_FLOPS, b / PEAK_BYTES
        return 1e3 * max(t_op, t_b), ("operations" if t_op >= t_b
                                      else "bytes")

    def lib_factor():
        l, _ = torch.linalg.cholesky_ex(m + torch.diag_embed(d))
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
    }
    for name, (ms, plain_ms, lib_ms, (bnd, by)) in t.items():
        records[name] = dict(max_abs_err=max_abs[name], ms=ms,
                             plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                             library_ms=lib_ms)
    emit({"phase": "kernel_times", "shape": [k, n, n], "times": records})
    del m, d, r, l2, eye

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


def run_suggest(torch, gk, label, reps, n, d, chains, cands, n_pending=0,
                n_fantasies=10, grid_subset=10, lbfgs_iters=20,
                profile=False):
    """``reps`` suggestions (the first a warm-up when reps > 1); fails
    unless every rep has finite EI and every kernel was launched.  Without
    pending jobs every rep needs n_ok == chains.  With pending jobs a
    sample whose float32 pending covariance is indefinite has NaN
    fantasies and drops out of the EI average, so n_ok must equal chains
    less the samples ``pending_witness`` finds indefinite, and be ≥ 1;
    and the float64 pending covariance must be positive definite in every
    sample.  Then one rep with stage timing and, with ``profile``, one
    under ``torch.profiler``."""
    from spearmint_tpu_torch.engine.suggest import (
        SuggestConfig, init_chain_states, suggest_step,
    )

    args = padded_problem(torch, n, d, cands, n_pending)
    xp, yp, mask = args[:3]
    cfg = SuggestConfig(mcmc_iters=1, grid_subset=grid_subset,
                        lbfgs_iters=lbfgs_iters, has_pending=n_pending > 0,
                        n_fantasies=n_fantasies)
    hypers = init_chain_states(torch.tensor(yp, device="cuda"),
                               torch.tensor(mask, device="cuda"), d, chains)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    gk.reset_launches()
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
    counts = dict(gk.launches)
    peak_bytes = torch.cuda.max_memory_allocated()
    if min(counts.values()) <= 0:
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
        gen, hypers, *args, cfg, device="cuda")) if profile else None)
    return dict(phase=label, n=n, pad=len(yp), chains=chains, cands=cands,
                n_pending=n_pending, n_fantasies=n_fantasies, reps=reps,
                latency_s=times, median_s=float(np.median(times[-3:])
                                                if reps > 1 else times[0]),
                launches=counts, n_ok=oks, ei_finite=True,
                pending_witness=witness,
                max_memory_allocated=peak_bytes,
                stage_s=stages, profile=prof, x_opt=res.x_opt.tolist(),
                ei_opt=float(res.ei_opt))


def profile_step(torch, fn, top=8):
    """One call of ``fn`` under ``torch.profiler``: its wall time, the
    device time of all its kernels and their share of the wall time (the
    device's busy share; the profiler's own host cost lowers it), and the
    kernels that took most device time, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, count = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:60]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
            count[name] = count.get(name, 0) + 1
    device_s = sum(by_name.values()) / 1e6
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(wall_s=wall, device_s=device_s, busy_share=device_s / wall,
                top_device_s=[[k, v / 1e6, count[k]] for k, v in ranked])


# --------------------------------------------------------------- phase 7
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


def run_chooser(torch, gk):
    gk.reset_launches()
    rec = branin_loop(torch, BRANIN_SEED)
    rec["launches"] = dict(gk.launches)
    emit(rec)
    if rec["evaluations"] != 16 or not rec["best"] < 3.0 \
            or not rec["state_file"]:
        fail(f"chooser loop: {rec}")
    if min(rec["launches"].values()) <= 0:
        fail(f"chooser loop: a kernel was never launched: {rec}")


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

    records = check_kernels(torch, gk)
    emit({"phase": "clocks_after_kernels",
          "clocks_sm": nvidia_smi("clocks.sm"),
          "power_draw": nvidia_smi("power.draw")})
    check_small_input(torch)

    flag = run_suggest(torch, gk, "flagship", 4, profile=True, **FLAGSHIP)
    emit(flag)
    pend = run_suggest(torch, gk, "pending_async_large", 1, **ASYNC_LARGE)
    emit(pend)
    run_chooser(torch, gk)

    replaces = {
        "B1": ("shifted_logdet_q", "spearmint_tpu_torch/ops/csrc/"
               "shifted_chol.cu", "spearmint_tpu/ops/pallas_gp.py:930"),
        "B2": ("shifted_factor_logdet_q", "spearmint_tpu_torch/ops/csrc/"
               "shifted_chol.cu", "spearmint_tpu/ops/pallas_gp.py:777"),
        "B3": ("tri_inverse", "spearmint_tpu_torch/ops/csrc/"
               "tri_inverse.cu", "spearmint_tpu/ops/pallas_gp.py:816"),
    }
    kernels = []
    for key, (name, src, rep) in replaces.items():
        kernels.append({
            "name": name, "id": key, "route": "cuda", "source": src,
            "replaces": rep, "launches": flag["launches"][name],
            "launches_pending": pend["launches"][name],
            **records[key]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
