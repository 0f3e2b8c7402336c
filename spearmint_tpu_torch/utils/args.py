"""Chooser argument-string parsing.

Copy of ``spearmint_tpu/utils/args.py`` (the port imports nothing of the JAX
package).

Parity: reference ``util.unpack_args`` (SURVEY.md §2 #7): chooser-specific
``--chooser-args="mcmc_iters=10,noiseless=1"`` strings become keyword
arguments for the chooser's ``init``.
"""

from __future__ import annotations


def _coerce(v: str):
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    return v


def unpack_args(arg_string: str | None) -> dict:
    out: dict = {}
    if not arg_string:
        return out
    for part in arg_string.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad chooser arg {part!r} (want key=value)")
        k, v = part.split("=", 1)
        out[k.strip()] = _coerce(v.strip())
    return out
