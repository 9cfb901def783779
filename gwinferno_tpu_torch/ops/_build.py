"""Building and loading the port's CUDA kernels.

Each kernel source under ``ops/csrc/`` has a plain C interface.  It is
compiled with ``nvcc`` into a shared library in ``gwinferno_tpu_torch/_build/``
(listed in ``.gitignore``) at first use and loaded with ``ctypes``.  No
PyTorch headers, no ``torch.utils.cpp_extension.load`` and no ninja: a build
takes seconds.  The library name carries a hash of the source and flags, so
an edited source is rebuilt and concurrent builds never see a half-written
file (each writes a private temporary name, then renames it into place).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["Kernel", "build_all", "nvcc_path", "BUILD_DIR"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc_path():
    """``nvcc`` from PyTorch's ``CUDA_HOME``, else from ``$PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (neither under CUDA_HOME nor on PATH); cannot build the CUDA kernels")
    return found


class Kernel:
    """One hand-written CUDA kernel: its source, its C functions and the
    count of its launches.

    ``functions`` maps each exported C function to its ctypes ``argtypes``;
    every C function returns ``int`` (a ``cudaError_t``), and each source
    also exports ``gw_cuda_error_string`` to name such a code.  ``launches`` is a
    plain integer that the wrapper adds one to where it launches the kernel.
    """

    def __init__(self, name, source, functions, replaces):
        self.name = name
        self.source = source
        self.functions = dict(functions)
        self.replaces = replaces
        self.launches = 0
        self._lib = None

    @property
    def source_path(self):
        return os.path.join(CSRC_DIR, self.source)

    def library_path(self):
        h = hashlib.sha256()
        with open(self.source_path, "rb") as f:
            h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        return os.path.join(BUILD_DIR, f"lib{self.name}_{h.hexdigest()[:16]}.so")

    def start_build(self):
        """Start ``nvcc`` for this kernel unless its library exists; returns
        ``(process, tmp_path, final_path)`` or None."""
        out = self.library_path()
        if os.path.exists(out):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, self.source_path]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp, out

    @staticmethod
    def finish_build(job):
        proc, tmp, out = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for {out}:\n{log}")
        os.replace(tmp, out)

    def lib(self):
        """The loaded library, built first if needed."""
        if self._lib is None:
            job = self.start_build()
            if job is not None:
                self.finish_build(job)
            lib = ctypes.CDLL(self.library_path())
            for fname, argtypes in self.functions.items():
                fn = getattr(lib, fname)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.gw_cuda_error_string.argtypes = [ctypes.c_int]
            lib.gw_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def call(self, fname, *args):
        """Call a C entry point and raise on a CUDA error (a refused launch
        never runs and a later synchronise would not report it)."""
        lib = self.lib()
        code = getattr(lib, fname)(*args)
        if code != 0:
            msg = lib.gw_cuda_error_string(code).decode()
            raise RuntimeError(f"{self.name}: {fname} failed with CUDA error {code}: {msg}")


def build_all(kernels):
    """Build every kernel's library, all ``nvcc`` processes started together;
    returns the wall seconds."""
    t0 = time.perf_counter()
    # kernels that share a source share one library: build it once
    first = {k.library_path(): k for k in reversed(kernels)}
    jobs = [job for job in (k.start_build() for k in first.values()) if job is not None]
    try:
        for job in jobs:
            Kernel.finish_build(job)
    finally:
        for proc, _, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for k in kernels:
        k.lib()
    return time.perf_counter() - t0
