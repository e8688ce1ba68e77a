"""Builds the package's kernels from the sources in the checkout.

CUDA C++ (``csrc/*.cu``, headers ``csrc/*.cuh``) is compiled by ``nvcc``
for ``sm_90a``, one process per source, all started together, and linked
into one shared library with a plain C interface, loaded with ``ctypes``.
The library's file name carries a hash of the sources and flags, so an
edited source rebuilds and an unchanged one is reused. Everything goes
under ``build/torch_kernels/`` at the repository root, which ``.gitignore``
lists. Nothing here runs at import.

Also here: the checks the wrappers share, and the TMA tensor-map geometry
(``tma_map``, ``map_words``) that the wgmma/TMA kernels' C side encodes.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Tuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _compile_and_link(sources, lib_path: str) -> None:
    """One ``nvcc -c`` per source, all running at once, then one link; the
    ``-Xptxas -v`` register report of each goes to ``<lib>.log``. Raises with
    the compiler's output when a step fails."""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, os.path.basename(s) + ".o") for s in sources]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c",
                                   "-o", o, s], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(s, p.returncode, log) for s, p, log in zip(sources, procs, logs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{s} ({rc}):\n{log}" for s, rc, log in failed))
        tmp_lib = os.path.join(tmpdir, "lib.so")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp_lib,
                               *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        with open(lib_path + ".log", "w") as f:
            f.write("\n".join(logs))
        os.replace(tmp_lib, lib_path)


_BUILD_LOCK = threading.Lock()
_STANDALONE_LOCK = threading.Lock()


def load_cuda_library() -> ctypes.CDLL:
    """Compile (if needed) and load ``libmagcache_kernels``; declares the C
    signatures. Raises with the compiler's output when nvcc fails. Threads
    that ask at once wait for one build."""
    with _BUILD_LOCK:
        return _load_cuda_library()


@functools.lru_cache(maxsize=None)
def _load_cuda_library() -> ctypes.CDLL:
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in headers + sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR,
                            f"libmagcache_kernels_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(lib_path):
        _compile_and_link(sources, lib_path)
    lib = ctypes.CDLL(lib_path)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    cl = ctypes.c_longlong
    pl = ctypes.POINTER(cl)
    lib.mc_flash_attention_tma.argtypes = [vp, vp, vp, vp, vp, vp, pl, pl, ci, ci, ci, ci,
                                           cf, ci, cf, vp]
    lib.mc_flash_attention_tma.restype = ci
    lib.mc_grouped_attention_tma.argtypes = [vp, vp, vp, vp, pl, ci, ci, ci, ci, ci, cf,
                                             ci, cf, vp]
    lib.mc_grouped_attention_tma.restype = ci
    lib.mc_qk_prepass.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, cl, cl,
                                  cl, cl, ci, ci, ci, ci, cf, cf, cf, vp]
    lib.mc_qk_prepass.restype = ci
    lib.mc_flash_attention_qknorm_tma.argtypes = [vp, vp, vp, vp, pl, pl, ci, ci, ci, ci,
                                                  cf, vp]
    lib.mc_flash_attention_qknorm_tma.restype = ci
    lib.mc_ln_modulate.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, cf, vp]
    lib.mc_ln_modulate.restype = ci
    lib.mc_layer_norm_mod.argtypes = [vp, vp, vp, cl, cl, vp, ci, ci, ci, ci, cf, vp]
    lib.mc_layer_norm_mod.restype = ci
    lib.mc_rms_norm_rope.argtypes = [vp, cl, cl, vp, ci, vp, vp, vp, ci, ci, ci, ci, cf, vp]
    lib.mc_rms_norm_rope.restype = ci
    lib.mc_rms_norm_rope_ext.argtypes = [vp, cl, cl, vp, vp, vp, vp, ci, vp, ci, ci, ci, cf,
                                         vp]
    lib.mc_rms_norm_rope_ext.restype = ci
    lib.mc_row_sumsq.argtypes = [vp, cl, cl, vp, ci, ci, ci, vp]
    lib.mc_row_sumsq.restype = ci
    lib.mc_hopper_gemm.argtypes = [vp, vp, pl, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
    lib.mc_hopper_gemm.restype = ci
    lib.mc_cross_attention_tma.argtypes = [vp, vp, vp, pl, vp, ci, ci, ci, ci, ci, cf, vp]
    lib.mc_cross_attention_tma.restype = ci
    lib.mc_matmul_gated_residual.argtypes = [vp, vp, pl, vp, vp, vp, vp, ci, ci, ci, ci,
                                             ci, ci, ci, vp]
    lib.mc_matmul_gated_residual.restype = ci
    lib.mc_grouped_stream.argtypes = [vp, vp, vp, pl, vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                      ci, ci, cf, cf, cf, cf, ci, ci, ci, vp]
    lib.mc_grouped_stream.restype = ci
    lib.mc_tiny_attention.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, cf, cf,
                                      vp]
    lib.mc_tiny_attention.restype = ci
    lib.mc_tiny_stream.argtypes = [vp, vp, vp, pl, vp, vp, vp, vp, vp, ci, ci, ci, cf, cf,
                                   ci, ci, ci, vp]
    lib.mc_tiny_stream.restype = ci
    lib.mc_row_quotient.argtypes = [vp, vp, vp, ci, vp]
    lib.mc_row_quotient.restype = ci
    lib.mc_error_string.argtypes = [ci]
    lib.mc_error_string.restype = ctypes.c_char_p
    return lib


def load_standalone_library(source: str) -> ctypes.CDLL:
    """Compiles one CUDA source outside ``csrc/`` (a yardstick kernel kept
    for a check, e.g. ``tools/ln_modulate_parent.cu``) into its own shared
    library under the build directory and loads it; the caller declares its
    C signatures. Raises with the compiler's output when nvcc fails."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"{os.path.basename(source)}_{digest}.so")
    with _STANDALONE_LOCK:       # apart from the library's: both may build at once
        if not os.path.exists(lib_path):
            _compile_and_link([os.path.abspath(source)], lib_path)
    return ctypes.CDLL(lib_path)


def check_bf16(name: str, t: torch.Tensor, shape, device) -> None:
    """Raises unless ``t`` is what a kernel takes: a contiguous, 16-byte
    aligned bf16 CUDA tensor of ``shape`` on ``device``."""
    if not (t.is_cuda and t.device == device and t.dtype == torch.bfloat16
            and t.is_contiguous() and tuple(t.shape) == tuple(shape)
            and t.data_ptr() % 16 == 0):
        raise ValueError(
            f"{name} must be a contiguous 16-byte aligned bf16 CUDA tensor of "
            f"shape {tuple(shape)} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def check_launch(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raises with CUDA's message when a launch returned an error code."""
    if code != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.mc_error_string(code).decode()} ({code})")


_COUNT_LOCK = threading.Lock()
_THREAD_TALLY = threading.local()


def count_launch(fn, attr: str = "launches", key=None) -> None:
    """Adds one to a wrapper's launch count ``fn.<attr>`` (or to its entry
    ``key`` when the count is a dict). Under a lock: the local ranks of a
    sequence-parallel run launch from several threads. Inside
    ``thread_launches`` the calling thread's tally counts it too."""
    with _COUNT_LOCK:
        if key is None:
            setattr(fn, attr, getattr(fn, attr) + 1)
        else:
            getattr(fn, attr)[key] += 1
    tally = getattr(_THREAD_TALLY, "counts", None)
    if tally is not None:
        name = (fn.__name__, attr, key)
        tally[name] = tally.get(name, 0) + 1


@contextlib.contextmanager
def thread_launches():
    """Yields a dict that tallies the launches this thread makes inside the
    block, by ``(wrapper name, count attribute, key)`` as ``count_launch``
    names them: one local rank's own launches, where the wrappers' counts
    sum over every rank."""
    outer = getattr(_THREAD_TALLY, "counts", None)
    _THREAD_TALLY.counts = tally = {}
    try:
        yield tally
    finally:
        _THREAD_TALLY.counts = outer


@dataclasses.dataclass(frozen=True)
class TmaMap:
    """One TMA tensor map's geometry, innermost dimension first: extents
    (elements), the byte strides of dimensions 1.., box extents, and the
    swizzle span in bytes (128, 32 for a box 16 values wide, or 0: none)."""
    dims: Tuple[int, ...]
    strides: Tuple[int, ...]
    box: Tuple[int, ...]
    swizzle: int

    def words(self) -> list:
        """The 16 integers the C side reads: rank, swizzle, 5 extents, 4
        byte strides, 5 box extents (unused trailing entries 1 or 0)."""
        pad = lambda xs, n, fill: list(xs) + [fill] * (n - len(xs))
        return [len(self.dims), self.swizzle, *pad(self.dims, 5, 1),
                *pad(self.strides, 4, 0), *pad(self.box, 5, 1)]


def tma_map(label: str, sizes, strides, box, swizzle: int, itemsize: int = 2) -> TmaMap:
    """A tensor map over a bf16 tensor of ``sizes`` with element ``strides``
    (both innermost first; the innermost stride must be 1). Raises
    ``ValueError`` naming ``label`` when TMA cannot describe it: byte
    strides must be multiples of 16 below 2**40. A dimension of extent 1
    is never stepped along, so its stride is not checked."""
    if strides[0] != 1:
        raise ValueError(f"{label}: TMA needs a unit innermost stride, got {tuple(strides)}")
    byte = []
    for n, st in zip(sizes[1:], strides[1:]):
        b = st * itemsize if n > 1 else 16
        if b % 16 or not 0 < b < 1 << 40:
            raise ValueError(f"{label}: TMA needs byte strides that are multiples of 16 "
                             f"bytes, got {[s * itemsize for s in strides[1:]]} for "
                             f"extents {tuple(sizes)}")
        byte.append(b)
    if any(not 1 <= n < 1 << 32 for n in sizes) or any(not 1 <= n <= 256 for n in box):
        raise ValueError(f"{label}: extents {tuple(sizes)} or box {tuple(box)} out of "
                         f"TMA's range")
    return TmaMap(tuple(sizes), tuple(byte), tuple(box), swizzle)


def map_words(maps):
    """The maps' geometry words as the C array the kernels read."""
    words = [w for m in maps for w in m.words()]
    return (ctypes.c_longlong * len(words))(*words)
