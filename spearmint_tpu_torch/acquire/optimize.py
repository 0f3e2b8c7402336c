"""Batched box-constrained L-BFGS for acquisition optimization.

JAX counterpart: ``spearmint_tpu/acquire/optimize.py``: a projected L-BFGS
over B starts advancing in lockstep — a fixed iteration count, a circular
(s, y) history, the two-loop recursion, active-set freezing of variables
pinned at a bound with an outward gradient, a parallel 8-step Armijo
ladder, and converged lanes frozen.

``fun`` maps points [M, D] → values [M], each point independent.  The
gradient comes from ``torch.autograd`` on the SUM over lanes, which gives
every lane its own gradient; the objective's constants (posterior caches)
are detached, so no kernel is ever differentiated.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class LBFGSResult(NamedTuple):
    x: torch.Tensor          # [B, D]
    fun: torch.Tensor        # [B]
    converged: torch.Tensor  # [B] bool


def _value_and_grad(fun, x):
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        f = fun(xg)
        (g,) = torch.autograd.grad(f.sum(), xg)
    return f.detach(), g


def _dot(a, b):
    return (a * b).sum(-1)


def _two_loop(g, s_hist, y_hist, rho_hist, valid):
    """Two-loop recursion, masked history; g [B, D], hist [B, m, D]."""
    m = s_hist.shape[1]
    q = g
    alphas = [None] * m
    for i in range(m - 1, -1, -1):
        a = torch.where(valid[:, i], rho_hist[:, i] * _dot(s_hist[:, i], q),
                        0.0)
        q = q - a[:, None] * y_hist[:, i]
        alphas[i] = a
    # initial Hessian scaling γ = sᵀy / yᵀy from the newest pair
    sy = _dot(s_hist[:, -1], y_hist[:, -1])
    yy = _dot(y_hist[:, -1], y_hist[:, -1])
    gamma = torch.where(valid[:, -1] & (yy > 0),
                        sy / torch.clamp_min(yy, 1e-20), 1.0)
    r = gamma[:, None] * q
    for i in range(m):
        b = torch.where(valid[:, i], rho_hist[:, i] * _dot(y_hist[:, i], r),
                        0.0)
        r = r + (alphas[i] - b)[:, None] * s_hist[:, i]
    return r  # ≈ H·g


def _push(hist, new, keep):
    """Append ``new`` [B, ...] to the circular history where ``keep``."""
    rolled = torch.cat([hist[:, 1:], new[:, None]], dim=1)
    k = keep.reshape(keep.shape + (1,) * (hist.ndim - 1))
    return torch.where(k, rolled, hist)


def minimize_lbfgs_b(fun: Callable[[torch.Tensor], torch.Tensor],
                     x0: torch.Tensor, lower: torch.Tensor,
                     upper: torch.Tensor, iters: int = 50,
                     history: int = 10, tol: float = 1e-6,
                     max_ls: int = 20) -> LBFGSResult:
    """Minimize ``fun`` from starts x0 [B, D] inside the box [lower, upper].

    Returns per-start optima; callers typically take the argmin lane."""
    dtype, dev = x0.dtype, x0.device
    n_start, dim = x0.shape
    lower = torch.broadcast_to(torch.as_tensor(lower, dtype=dtype,
                                               device=dev), (dim,))
    upper = torch.broadcast_to(torch.as_tensor(upper, dtype=dtype,
                                               device=dev), (dim,))

    def project(x):
        return torch.clamp(x, lower, upper)

    x = project(x0)
    f, g = _value_and_grad(fun, x)
    s_hist = torch.zeros(n_start, history, dim, dtype=dtype, device=dev)
    y_hist = torch.zeros_like(s_hist)
    rho_hist = torch.zeros(n_start, history, dtype=dtype, device=dev)
    valid = torch.zeros(n_start, history, dtype=torch.bool, device=dev)
    done = torch.zeros(n_start, dtype=torch.bool, device=dev)

    # parallel line search: one batched evaluation of a fixed step ladder
    # 1, 1/4, 1/16, ... instead of sequential backtracking
    n_steps = min(max_ls, 8)
    ladder = torch.tensor([2.0 ** (-i) for i in range(0, 2 * n_steps, 2)],
                          dtype=dtype, device=dev)
    bound_eps = 10.0 * torch.finfo(dtype).eps * torch.clamp_min(
        (upper - lower).max(), 1.0)

    for _ in range(iters):
        # active set (L-BFGS-B's gradient projection): a variable pinned
        # at a bound with an outward gradient is frozen this step
        active = (((x <= lower + bound_eps) & (g > 0))
                  | ((x >= upper - bound_eps) & (g < 0)))
        g_free = torch.where(active, 0.0, g)
        d = -_two_loop(g_free, s_hist, y_hist, rho_hist, valid)
        d = torch.where(active, 0.0, d)
        descent = _dot(d, g_free) < 0
        d = torch.where(descent[:, None], d, -g_free)

        x_trys = project(x[:, None, :] + ladder[None, :, None] * d[:, None, :])
        f_trys = fun(x_trys.reshape(-1, dim)).reshape(n_start, -1)
        armijo = f_trys <= f[:, None] + 1e-4 * _dot(x_trys - x[:, None],
                                                    g[:, None])
        # the largest Armijo step: the first True of the descending ladder
        first_ok = armijo.to(torch.int32).argmax(1)
        any_ok = armijo.any(1)
        pick = torch.where(any_ok, first_ok, f_trys.argmin(1))
        lane = torch.arange(n_start, device=dev)
        ls_ok = any_ok | (f_trys[lane, pick] < f)
        x_new = torch.where(ls_ok[:, None], x_trys[lane, pick], x)
        f_new, g_new = _value_and_grad(fun, x_new)
        improved = f_new < f
        x_new = torch.where(improved[:, None], x_new, x)
        f_new = torch.where(improved, f_new, f)
        g_new = torch.where(improved[:, None], g_new, g)

        s = x_new - x
        yv = g_new - g
        sy = _dot(s, yv)
        keep = improved & (sy > 1e-10)
        s_new = _push(s_hist, s, keep)
        y_new = _push(y_hist, yv, keep)
        rho_new = _push(rho_hist, 1.0 / sy, keep)
        valid_new = _push(valid, torch.ones_like(keep), keep)

        pg = x_new - project(x_new - g_new)
        done_new = (done | (pg.abs().amax(-1) < tol)
                    | (~improved & ~ls_ok))

        # freeze converged lanes: a lane done before this step keeps its state
        def frz(old, new):
            return torch.where(done.reshape(done.shape + (1,) * (old.ndim - 1)),
                               old, new)

        x, f, g = frz(x, x_new), frz(f, f_new), frz(g, g_new)
        s_hist, y_hist = frz(s_hist, s_new), frz(y_hist, y_new)
        rho_hist, valid = frz(rho_hist, rho_new), frz(valid, valid_new)
        done = frz(done, done_new)
    return LBFGSResult(x=x, fun=f, converged=done)
