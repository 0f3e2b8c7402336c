"""Build and load the hand-written CUDA kernels (``ops/csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``.  Libraries go to
``ops/_build/<hash>/`` (listed in ``.gitignore``), keyed by a hash of the
sources and flags, so a checkout builds everything at first use and never
reuses a stale library.  ``build_all`` starts one ``nvcc`` per source at
once and waits for all of them.  A missing ``nvcc`` raises.

No JAX counterpart: the JAX package compiled its Pallas kernels through
``jax.jit``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_build")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]

# C signatures of the entry points: every pointer and the stream are
# c_void_p (a plain int would cut a 64-bit pointer), sizes are c_int.
# spm_shifted_chol takes a null dshift for the unshifted kernels (B4).
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SOURCES = {
    "shifted_chol": {"spm_shifted_chol": [_P] * 8 + [_I, _I, _I, _P]},
    "tri_inverse": {"spm_tri_inverse": [_P, _P, _I, _I, _P]},
    "cyclic_reduction": {"spm_cyclic_reduction": [_P] * 6 + [_I] * 4
                         + [_L, _P]},
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of spearmint_tpu_torch cannot be built")


def _build_dir() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for fname in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def _lib_path(name: str) -> str:
    return os.path.join(_build_dir(), f"lib{name}.so")


def build_all() -> dict[str, float]:
    """Compile every source not yet built, all ``nvcc`` runs at once.

    Returns {name: seconds} for the sources compiled by this call.
    """
    out_dir = _build_dir()
    todo = [n for n in SOURCES if not os.path.exists(_lib_path(n))]
    if not todo:
        return {}
    nvcc = _nvcc()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = _lib_path(name) + f".{os.getpid()}.tmp"
        cmd = [nvcc, *FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    took, failed = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one source, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if not os.path.exists(_lib_path(name)):
            build_all()
        lib = ctypes.CDLL(_lib_path(name))
        for fn, argtypes in SOURCES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib
