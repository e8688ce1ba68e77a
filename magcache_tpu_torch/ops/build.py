"""Builds the package's kernels from the sources in the checkout.

CUDA C++ (``csrc/*.cu``) is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface and loaded with ``ctypes``. The
library's file name carries a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused. Triton kernels
(``csrc/prologue_triton.py``) compile at their first launch; their cache is
kept beside the library. Everything goes under ``build/torch_kernels/`` at
the repository root, which ``.gitignore`` lists. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


@functools.lru_cache(maxsize=None)
def load_cuda_library() -> ctypes.CDLL:
    """Compile (if needed) and load ``libmagcache_kernels``; declares the C
    signatures. Raises with the compiler's output when nvcc fails."""
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR,
                            f"libmagcache_kernels_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(lib_path):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        with open(lib_path + ".log", "w") as f:   # -Xptxas -v register report
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mc_flash_attention_bshd.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                            cf, ci, cf, vp]
    lib.mc_flash_attention_bshd.restype = ci
    lib.mc_error_string.argtypes = [ci]
    lib.mc_error_string.restype = ctypes.c_char_p
    return lib


def triton_prologue():
    """The Triton kernel module, imported on first use (needs ``triton``)."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(BUILD_DIR, "triton"))
    from magcache_tpu_torch.csrc import prologue_triton
    return prologue_triton
