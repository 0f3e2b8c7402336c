"""Carry chain state between the JAX package and the port.

Both choosers keep the chains' hyperparameters in
``<Chooser>_state.npz`` under the keys ``mean, amp2, noise, ls`` (leading
chains axis).  These two functions turn such arrays into the port's
``GPHypers`` and back, so an experiment written by either package resumes
under the other.  No JAX counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from spearmint_tpu_torch.core.likelihood import GPHypers


def hypers_from_numpy(arrays, device) -> GPHypers:
    """{mean, amp2, noise: [chains], ls: [chains, D]} → GPHypers on device."""
    return GPHypers(*(
        torch.as_tensor(np.asarray(arrays[k], np.float32), device=device)
        for k in GPHypers._fields))


def hypers_to_numpy(hypers: GPHypers) -> dict:
    """GPHypers → {mean, amp2, noise, ls} as float32 numpy arrays."""
    return {k: v.detach().cpu().numpy().astype(np.float32)
            for k, v in hypers._asdict().items()}
