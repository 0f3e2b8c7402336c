"""Typed parameter values ↔ unit-hypercube coordinates.

Copy of ``spearmint_tpu/store/varmap.py`` (the port imports nothing of the JAX
package).

The grid lives in [0,1]^D; user-facing files (results.dat, job params)
use the typed space declared in the experiment config.  Decoding
(unit→typed) matches ``ExperimentGrid.get_params`` (reference ≈L120);
encoding (typed→unit) is its inverse, used by spearmint-lite to rebuild
a transient grid from a results file.
"""

from __future__ import annotations

import numpy as np


def _vars_as_dicts(variables):
    out = []
    for v in variables:
        if isinstance(v, dict):
            out.append(v)
        else:
            out.append({"name": v.name, "type": v.type, "size": v.size,
                        "min": v.min, "max": v.max,
                        "options": list(v.options)})
    return out


def grid_dims(variables) -> int:
    return sum(int(v["size"]) for v in _vars_as_dicts(variables))


def unit_to_typed(variables, point) -> list:
    """Flat list of typed values for one unit-hypercube row."""
    out = []
    offset = 0
    for v in _vars_as_dicts(variables):
        size = int(v["size"])
        coords = np.asarray(point[offset:offset + size], dtype=float)
        offset += size
        if v["type"] == "INT":
            out.extend(int(v["min"] + round(c * (v["max"] - v["min"])))
                       for c in coords)
        elif v["type"] == "FLOAT":
            out.extend(float(v["min"] + c * (v["max"] - v["min"]))
                       for c in coords)
        elif v["type"] == "ENUM":
            opts = v["options"]
            out.extend(opts[min(int(c * len(opts)), len(opts) - 1)]
                       for c in coords)
        else:
            raise ValueError(f"bad variable type {v['type']}")
    return out


def typed_to_unit(variables, tokens) -> np.ndarray:
    """Inverse mapping for one flat row of typed tokens (strings ok)."""
    point = []
    i = 0
    want = grid_dims(variables)
    if len(tokens) != want:
        raise ValueError(f"row has {len(tokens)} values, config wants {want}")
    for v in _vars_as_dicts(variables):
        for _ in range(int(v["size"])):
            tok = tokens[i]
            i += 1
            if v["type"] == "ENUM":
                opts = list(v["options"])
                idx = opts.index(str(tok))
                point.append((idx + 0.5) / len(opts))
            else:
                val = float(tok)
                span = float(v["max"]) - float(v["min"])
                point.append((val - float(v["min"])) / span)
    return np.clip(np.asarray(point, dtype=np.float64), 0.0, 1.0)
