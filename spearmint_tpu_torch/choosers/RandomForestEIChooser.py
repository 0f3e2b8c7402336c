"""Random-forest EI chooser (host-side, sklearn).

Parity: reference ``chooser/RandomForestEIChooser.py`` (≈150 LoC,
SURVEY.md §2 #17 — presence marked [verify] there; provided for
completeness).

Copy of ``spearmint_tpu/choosers/RandomForestEIChooser.py``: with the same
seed it picks the same candidate as the JAX chooser.  scikit-learn is
imported inside ``_fit``, so the module imports without it.

A regression forest replaces the GP: per-tree
predictions at the candidate points give a predictive mean and spread,
EI is computed from those moments, and the suggestion is the EI argmax
over the existing grid candidates (never invents off-grid points).

Pending jobs are fantasized with the forest's own mean prediction (the
tree analogue of the GP choosers' posterior-mean Kriging believer),
so concurrent suggestions spread out instead of piling up.

This chooser is deliberately host-side CPU: the forest is sklearn, not
a device workload — it is an alternative *brain* behind the same
``init()/next()`` protocol, exercising the harness's chooser plugin
surface with a non-GP model.
"""

from __future__ import annotations

import numpy as np

from spearmint_tpu_torch.utils.args import unpack_args


def init(expt_dir, arg_string=""):
    return RandomForestEIChooser(expt_dir, **unpack_args(arg_string))


class RandomForestEIChooser:
    def __init__(self, expt_dir, n_trees=50, max_depth=0, seed=0,
                 min_sigma=1e-6):
        self.expt_dir = expt_dir
        self.n_trees = int(n_trees)
        self.max_depth = int(max_depth) or None  # 0 → unlimited
        self.seed = int(seed)
        self.min_sigma = float(min_sigma)

    def _fit(self, x, y):
        from sklearn.ensemble import RandomForestRegressor

        forest = RandomForestRegressor(
            n_estimators=self.n_trees, max_depth=self.max_depth,
            random_state=self.seed, bootstrap=True,
        )
        forest.fit(x, y)
        return forest

    @staticmethod
    def _moments(forest, x):
        """Predictive mean/std across trees at points x."""
        preds = np.stack([t.predict(x) for t in forest.estimators_])
        return preds.mean(axis=0), preds.std(axis=0)

    def next(self, grid, values, durations, candidates, pending, complete):
        if len(complete) < 2:
            return int(candidates[0])

        x = grid[complete]
        y = values[complete].astype(float)

        if len(pending):
            # Kriging-believer fantasies from a forest fit on completes.
            base = self._fit(x, y)
            fant = base.predict(grid[pending])
            x = np.vstack([x, grid[pending]])
            y = np.concatenate([y, fant])

        forest = self._fit(x, y)
        cand = grid[candidates]
        mu, sigma = self._moments(forest, cand)
        sigma = np.maximum(sigma, self.min_sigma)

        from scipy import stats

        best = float(np.min(y))
        u = (best - mu) / sigma
        ei = sigma * (u * stats.norm.cdf(u) + stats.norm.pdf(u))
        return int(candidates[int(np.argmax(ei))])
