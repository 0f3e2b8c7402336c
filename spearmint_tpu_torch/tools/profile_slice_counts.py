"""Slice-sampler evaluation counts and the lockstep tax.

JAX counterpart: ``bin/profile_slice_counts.py``.  Runs the flagship MCMC
configuration (D 2, 10 chains, the flagship's synthetic data at n
observations) for a number of carried sweeps of ``mcmc/chains``'s own
``sample_hypers_lp`` with its loop counters, and prints, per move
(joint, and each length-scale component):

  * evaluations per move (mean / p50 / p90 / p99 / max): lo + up + sh + 2
    for a chain that stepped out, sh for one that did not
    (``slice.move_evals``);
  * the shrink budget's headroom against MAX_SHRINK, and the step-out
    expansions against MAX_STEPS_OUT;
  * the lockstep tax: the batch's evaluations a sweep (each move runs the
    slowest chain's count) against a sequential chain's mean;
  * the 2×5 chunk what-if: two groups of five chains, each paying its own
    slowest chain.

In this engine the evaluations are the cost: every lockstep evaluation at
a pad of 512 or more is one B1 launch on the card.  ``--data branin``
takes the sync harness's data instead: the first n points of the
2000-point Sobol grid (seed 1) of ``examples/braninpy`` with their Branin
values, as the harness passes them to the chooser.  The last line printed
is one JSON object of the same statistics.

Usage:
    python -m spearmint_tpu_torch.tools.profile_slice_counts [sweeps] [n]
        [--device cuda|cpu] [--data synthetic|branin]
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

D, CHAINS = 2, 10
HARNESS_GRID = dict(grid_size=2000, grid_seed=1)


def make_problem(n, d, seed=0):
    """The flagship's synthetic data (the JAX tool's ``make_problem``)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, d)
    y = np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + 0.05 * rng.randn(n)
    return x, y - y.mean()


def branin_problem(n):
    """The sync harness's first n completions on examples/braninpy: its
    Sobol grid's first n points and their Branin values."""
    from spearmint_tpu_torch.store.sobol import sobol_grid

    u = sobol_grid(2, HARNESS_GRID["grid_size"], HARNESS_GRID["grid_seed"])[:n]
    a, b = 15.0 * u[:, 0] - 5.0, 15.0 * u[:, 1]
    y = ((b - 5.1 / (4 * math.pi ** 2) * a ** 2 + 5 / math.pi * a - 6) ** 2
         + 10 * (1 - 1 / (8 * math.pi)) * np.cos(a) + 10)
    return u, y


def collect(sweeps, x, y, device="cuda"):
    """``sweeps`` carried sweeps of CHAINS chains from the reference-init
    states on the padded (x, y), the generator seeded with 0.  Returns
    (joint counts [S, K, 3], ls counts [S, K, D, 3], started finite
    [S, K]) as numpy.  A chain whose sweep started at a finite density
    steps out on every move of it (a finite slice stays finite), so the
    evaluations are exact when every sweep started finite."""
    from spearmint_tpu_torch.core.linalg import pad_bucket
    from spearmint_tpu_torch.engine.suggest import init_chain_states
    from spearmint_tpu_torch.mcmc.chains import (
        MCMCConfig, sample_hypers_lp, seed_lp,
    )
    from spearmint_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    n, d = x.shape
    pad = pad_bucket(n)
    xp = np.zeros((pad, d), np.float32); xp[:n] = x
    yp = np.zeros(pad, np.float32); yp[:n] = y
    xt = torch.as_tensor(xp, device=dev)
    yt = torch.as_tensor(yp, device=dev)
    mt = torch.as_tensor(np.arange(pad) < n, device=dev)
    hypers = init_chain_states(yt, mt, d, CHAINS)
    mcfg = MCMCConfig()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    lp = seed_lp(xt, yt, mt, hypers, mcfg)
    cj, cl, fin = [], [], []
    for _ in range(sweeps):
        fin.append(torch.isfinite(lp))
        hypers, lp, (c_joint, c_ls) = sample_hypers_lp(
            gen, hypers, lp, xt, yt, mt, mcfg, with_counts=True)
        cj.append(c_joint)
        cl.append(c_ls)
    return tuple(torch.stack(a).cpu().numpy() for a in (cj, cl, fin))


def _quantiles(e):
    q = np.percentile
    return {"mean": float(e.mean()), "p50": float(q(e, 50)),
            "p90": float(q(e, 90)), "p99": float(q(e, 99)),
            "max": float(e.max())}


def summarize(cj, cl, fin):
    """The JAX tool's statistics of (joint [S, K, 3], ls [S, K, D, 3],
    started finite [S, K]) as a dict."""
    from spearmint_tpu_torch.mcmc.slice import (
        MAX_SHRINK, MAX_STEPS_OUT, move_evals,
    )

    fin = torch.as_tensor(fin)
    ej = move_evals(torch.as_tensor(cj), fin).numpy()              # [S, K]
    el = move_evals(torch.as_tensor(cl), fin[..., None]).numpy()   # [S, K, D]
    d = el.shape[-1]
    moves = {"joint": (ej, cj[..., 2])}
    moves.update({f"ls[{i}]": (el[..., i], cl[..., i, 2]) for i in range(d)})
    out = {"moves": {}}
    for name, (e, sh) in moves.items():
        out["moves"][name] = {
            "evals": _quantiles(e),
            "shrink": {**_quantiles(sh),
                       "p99.9": float(np.percentile(sh, 99.9)),
                       "budget": MAX_SHRINK}}
    so = np.concatenate([cj[..., :2].ravel(), cl[..., :2].ravel()])
    out["step_out"] = {"mean": float(so.mean()),
                       "p99": float(np.percentile(so, 99)),
                       "max": float(so.max()), "budget": MAX_STEPS_OUT}
    lock = ej.max(1) + el.max(1).sum(-1)            # [S]
    seq = (ej + el.sum(-1)).mean(1)
    g = ej.shape[1] // 2
    lock2 = (ej[:, :g].max(1) + ej[:, g:].max(1)
             + el[:, :g].max(1).sum(-1) + el[:, g:].max(1).sum(-1))
    out.update(lockstep_per_sweep=lock.tolist(),
               lockstep_mean=float(lock.mean()),
               sequential_mean=float(seq.mean()),
               tax=float(lock.mean() / seq.mean()),
               chunk2x5_mean=float(lock2.mean()),
               nonfinite_starts=int((~fin).sum()))
    return out


def report(stats) -> None:
    """The JAX tool's printed lines."""
    for name, m in stats["moves"].items():
        e, sh = m["evals"], m["shrink"]
        print(f"{name}: evals mean {e['mean']:.2f} p50 {e['p50']:.0f} "
              f"p90 {e['p90']:.0f} p99 {e['p99']:.0f} max {e['max']:.0f}")
        print(f"{name}: shrink evals mean {sh['mean']:.2f} "
              f"p99 {sh['p99']:.0f} p99.9 {sh['p99.9']:.1f} "
              f"max {sh['max']:.0f} (budget {sh['budget']})")
    so = stats["step_out"]
    print(f"step_out expansions: mean {so['mean']:.2f} p99 {so['p99']:.0f} "
          f"max {so['max']:.0f} (budget {so['budget']})")
    print(f"lockstep evals/sweep: mean {stats['lockstep_mean']:.1f} "
          f"(sequential-chain mean {stats['sequential_mean']:.1f} -> tax "
          f"{stats['tax']:.2f}x)")
    print(f"2x5-chunk evals/sweep: mean {stats['chunk2x5_mean']:.1f} "
          f"(vs 1x10 {stats['lockstep_mean']:.1f}; chunked runs each group "
          f"sequentially at half batch width)")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sweeps", nargs="?", type=int, default=20)
    ap.add_argument("n", nargs="?", type=int, default=5000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data", choices=("synthetic", "branin"),
                    default="synthetic")
    args = ap.parse_args(argv)
    print(f"# device: {args.device}  n={args.n} chains={CHAINS} "
          f"sweeps={args.sweeps} data={args.data}")
    x, y = (branin_problem(args.n) if args.data == "branin"
            else make_problem(args.n, D))
    t0 = time.perf_counter()
    stats = summarize(*collect(args.sweeps, x, y, args.device))
    report(stats)
    stats = {"tool": "profile_slice_counts", "device": args.device,
             "n": args.n, "data": args.data, "sweeps": args.sweeps,
             "chains": CHAINS,
             "seconds": time.perf_counter() - t0, **stats}
    print(json.dumps(stats), flush=True)
    return stats


if __name__ == "__main__":
    main()
