"""Carry chain state between the JAX package and the port.

Both packages' choosers keep the chains' hyperparameters in
``<Chooser>_state.npz`` under the keys ``mean, amp2, noise, ls`` (leading
chains axis), and the constrained chooser its constraint model under
``c_ls, c_amp2, c_ff``.  These functions turn such arrays into the port's
``GPHypers`` / ``ConstraintState`` and back, so an experiment written by
either package resumes under the other.  No JAX counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from spearmint_tpu_torch.core.likelihood import GPHypers
from spearmint_tpu_torch.engine.constrained import ConstraintState

_CONSTRAINT_KEYS = {"ls": "c_ls", "amp2": "c_amp2", "ff": "c_ff"}


def hypers_from_numpy(arrays, device) -> GPHypers:
    """{mean, amp2, noise: [chains], ls: [chains, D]} → GPHypers on device."""
    return GPHypers(*(
        torch.as_tensor(np.asarray(arrays[k], np.float32), device=device)
        for k in GPHypers._fields))


def hypers_to_numpy(hypers: GPHypers) -> dict:
    """GPHypers → {mean, amp2, noise, ls} as float32 numpy arrays."""
    return {k: v.detach().cpu().numpy().astype(np.float32)
            for k, v in hypers._asdict().items()}


def constraint_from_numpy(arrays, device) -> ConstraintState:
    """{c_ls: [chains, D], c_amp2: [chains], c_ff: [chains, N]} →
    ConstraintState on device."""
    return ConstraintState(*(
        torch.as_tensor(np.asarray(arrays[_CONSTRAINT_KEYS[k]], np.float32),
                        device=device)
        for k in ConstraintState._fields))


def constraint_to_numpy(state: ConstraintState) -> dict:
    """ConstraintState → {c_ls, c_amp2, c_ff} as float32 numpy arrays."""
    return {_CONSTRAINT_KEYS[k]: v.detach().cpu().numpy().astype(np.float32)
            for k, v in state._asdict().items()}
