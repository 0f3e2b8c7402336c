"""spearmint-lite: suggest-only batch interface over a results file.

Parity: reference ``spearmint-lite.py`` (≈350 LoC, SURVEY.md §2 #13 /
§3.5): no job execution at all.  ``results.dat`` in the experiment dir
holds one whitespace-separated row per evaluation:

    <value> <duration> <p1> <p2> ...     completed row (typed values)
    P P <p1> <p2> ...                    pending row (user is running it)

Each invocation appends ``--n`` suggested rows, each marked pending so
the next suggestion within the batch fantasizes against it — the
reference's sequential-batch semantics.  The user fills in value and
duration in place and re-runs for more suggestions.

JAX counterpart: ``spearmint_tpu/harness/lite.py``: the same file format,
CLI and batch semantics, on the port's varmap, Sobol grid, locker, codec
and chooser registry.  The GP choosers run on their ``device`` argument
(``--chooser-args="device=cpu"`` without a card).

Usage:
    python -m spearmint_tpu_torch.harness.lite EXPT_DIR [flags]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from spearmint_tpu_torch.choosers import get_chooser
from spearmint_tpu_torch.store import codec, varmap
from spearmint_tpu_torch.store.locker import Locker
from spearmint_tpu_torch.store.sobol import sobol_grid

PENDING_MARK = "P"


def parse_results(path: str, variables):
    """→ (completed_points, values, durations, pending_points)."""
    comp, vals, durs, pend = [], [], [], []
    if not os.path.exists(path):
        return comp, vals, durs, pend
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            tokens = line.split()
            if not tokens:
                continue
            if len(tokens) < 3:
                raise ValueError(f"{path}:{lineno}: too few columns")
            value_tok, dur_tok, params = tokens[0], tokens[1], tokens[2:]
            point = varmap.typed_to_unit(variables, params)
            if value_tok == PENDING_MARK:
                pend.append(point)
            else:
                comp.append(point)
                vals.append(float(value_tok))
                durs.append(1.0 if dur_tok == PENDING_MARK
                            else float(dur_tok))
    return comp, vals, durs, pend


def suggest_batch(expt_dir, config, chooser, n, grid_size, grid_seed,
                  results_file="results.dat"):
    """Append n suggestions to the results file; returns the typed rows."""
    path = os.path.join(expt_dir, results_file)
    locker = Locker(path)
    new_rows = []
    with locker:
        for _ in range(n):
            comp, vals, durs, pend = parse_results(path, config.variables)
            ndim = varmap.grid_dims(config.variables)
            base = sobol_grid(ndim, grid_size, grid_seed)
            # transient grid: sobol candidates + observed + pending rows
            grid = np.vstack([base] + [np.asarray(p)[None] for p in
                                       comp + pend]) if (comp or pend) \
                else base
            n_base = base.shape[0]
            values = np.full(grid.shape[0], np.nan)
            durations = np.full(grid.shape[0], np.nan)
            complete_idx = np.arange(n_base, n_base + len(comp))
            values[complete_idx] = vals
            durations[complete_idx] = durs
            pending_idx = np.arange(n_base + len(comp), grid.shape[0])
            # Base-grid rows that coincide with an observed or pending
            # point are no longer candidates — without this, Random/
            # Sequential choosers re-suggest completed points (the typed
            # round-trip quantizes, so compare in unit space with a
            # tolerance wide enough to absorb INT/ENUM decode rounding).
            candidates = np.arange(n_base)
            taken = comp + pend
            if taken:
                # Observed rows round-tripped through typed space (INT
                # rounds, ENUM bins), so canonicalize base rows the same
                # way before comparing.
                canon = np.stack([
                    varmap.typed_to_unit(
                        config.variables,
                        [str(t) for t in
                         varmap.unit_to_typed(config.variables, b)])
                    for b in base])
                d2 = ((canon[:, None, :] - np.asarray(taken)[None, :, :]) ** 2
                      ).sum(-1)
                candidates = candidates[d2.min(axis=1) > 1e-12]
            if len(candidates) == 0:
                raise RuntimeError(
                    f"grid exhausted: all {n_base} base points evaluated "
                    "or pending; raise --grid-size")

            selected = chooser.next(grid, values, durations, candidates,
                                    pending_idx, complete_idx)
            if isinstance(selected, tuple):
                _, point = selected
                point = np.clip(np.asarray(point, dtype=float), 0, 1)
            else:
                point = grid[int(selected)]
            typed = varmap.unit_to_typed(config.variables, point)
            row = " ".join([PENDING_MARK, PENDING_MARK]
                           + [str(t) for t in typed])
            with open(path, "a") as f:
                f.write(row + "\n")
            new_rows.append(typed)
            codec.log(f"suggested: {typed}")
    return new_rows


def build_parser():
    p = argparse.ArgumentParser(
        prog="spearmint-tpu-torch-lite",
        description="suggest-only Bayesian optimization over results.dat",
    )
    p.add_argument("expt_dir")
    p.add_argument("--config", default=None)
    p.add_argument("--n", type=int, default=1,
                   help="number of suggestions to append")
    p.add_argument("--grid-size", type=int, default=1000)
    p.add_argument("--grid-seed", type=int, default=1)
    p.add_argument("--chooser-module", default="GPEIOptChooser")
    p.add_argument("--chooser-args", default="")
    p.add_argument("--results", default="results.dat")
    return p


def main(argv=None) -> int:
    options = build_parser().parse_args(argv)
    expt_dir = os.path.realpath(options.expt_dir)
    config_path = options.config or os.path.join(expt_dir, "config.pb")
    config = codec.load_experiment(config_path)
    chooser = get_chooser(options.chooser_module, expt_dir,
                          options.chooser_args)
    suggest_batch(expt_dir, config, chooser, options.n, options.grid_size,
                  options.grid_seed, options.results)
    return 0


def cli():
    raise SystemExit(main())


if __name__ == "__main__":
    cli()
