"""ctypes bindings for the C++/OpenMP chi_p prior library.

Counterpart of ``gwinferno_tpu/preprocess/native.py``: host code, not a
device kernel.  :func:`chi_p_prior_given_chi_eff_q_batch` evaluates the
conditional prior p(chi_p | chi_eff, q) over a batch of samples in
``csrc/chi_p_prior.cpp`` (this package's copy of the JAX package's source),
threaded over samples with one RNG stream per index, so the result does not
depend on the thread count.  The library is built with ``g++`` at first use
into ``gwinferno_tpu_torch/_build/`` under a name that carries a hash of the
source and flags (a private temporary name renamed into place, so concurrent
builds never see a half-written file).  Without a compiler every entry point
falls back to the Python KDE path of :mod:`.priors`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

from ..ops._build import BUILD_DIR

__all__ = ["native_available", "native_num_threads", "chi_p_prior_given_chi_eff_q_batch"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "chi_p_prior.cpp")
# the JAX package's native/Makefile flags
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17", "-Wall", "-shared")


def library_path():
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libgwinferno_native_{h.hexdigest()[:16]}.so")


@functools.cache
def _load():
    """The loaded library, built first if needed; None without a working
    ``g++``."""
    out = library_path()
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE], check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            return None
        os.replace(tmp, out)
    try:
        lib = ctypes.CDLL(out)
    except OSError:
        return None
    dp = ctypes.POINTER(ctypes.c_double)
    lib.chi_p_prior_batch.argtypes = [dp, dp, dp, ctypes.c_int64, ctypes.c_double, ctypes.c_int, ctypes.c_uint64, dp]
    lib.chi_p_prior_batch.restype = None
    lib.chi_p_prior_num_threads.argtypes = []
    lib.chi_p_prior_num_threads.restype = ctypes.c_int
    return lib


def native_available():
    return _load() is not None


def native_num_threads():
    """The library's OpenMP thread count, or None without the library."""
    lib = _load()
    return None if lib is None else int(lib.chi_p_prior_num_threads())


def chi_p_prior_given_chi_eff_q_batch(chi_p, chi_eff, q, a_max=1.0, ndraws=10000, seed=0):
    """Vector of p(chi_p_i | chi_eff_i, q_i) over sample triples (``chi_eff``
    and ``q`` broadcast to ``chi_p``'s shape).

    Uses the OpenMP C++ library when it builds; otherwise the vectorized
    Python path.
    """
    chi_p = np.ascontiguousarray(np.atleast_1d(chi_p), dtype=np.float64)
    chi_eff = np.ascontiguousarray(np.broadcast_to(chi_eff, chi_p.shape), dtype=np.float64).copy()
    q = np.ascontiguousarray(np.broadcast_to(q, chi_p.shape), dtype=np.float64).copy()
    lib = _load()
    if lib is None:
        from .priors import chi_p_prior_given_chi_eff_q

        f = np.vectorize(chi_p_prior_given_chi_eff_q, excluded=["a_max", "ndraws"])
        return f(chi_p, chi_eff, q, a_max=a_max, ndraws=ndraws)
    out = np.empty(chi_p.shape[0], dtype=np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.chi_p_prior_batch(chi_p.ctypes.data_as(dp), chi_eff.ctypes.data_as(dp), q.ctypes.data_as(dp),
                          ctypes.c_int64(chi_p.shape[0]), ctypes.c_double(a_max), ctypes.c_int(int(ndraws)),
                          ctypes.c_uint64(int(seed)), out.ctypes.data_as(dp))
    return out
