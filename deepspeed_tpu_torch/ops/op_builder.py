"""Builders for the port's native libraries (counterpart of ``deepspeed_tpu/ops/op_builder.py``).

Each source under ``deepspeed_tpu_torch/csrc/`` has a plain C entry point
and is compiled at first use into a shared library that ``ctypes`` loads:

- ``CUDAOpBuilder``: a kernel source, with ``nvcc`` for Hopper (``sm_90a``).
  No PyTorch header is compiled, so a build takes seconds, not minutes.
- ``HostOpBuilder``: a host library of ZeRO-Offload (the CPU Adam, the
  async I/O), with ``g++`` and the JAX builder's flags (``-O3 -march=native
  -fopenmp``, ``op_builder.py:35-36``).

A library lands in ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), under a name that carries the hash of the source, the
headers of ``csrc/`` it may include and the flags (for a host library also
the CPU's model and flags, since ``-march=native`` targets the machine that
builds): an edited source or header builds anew, an unchanged one is loaded
as it is. Each build writes a file of its own and renames it into place, so
processes building the same library at once never load a torn file.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

from ..utils.logging import logger

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_ROOT), "build", "kernels")


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the toolkit's
    default location. Raises when there is none: a kernel is never replaced
    by its plain version because the compiler is missing."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on the PATH); "
                       "the CUDA kernels are built from source at first use")


class CUDAOpBuilder:
    """Compile-on-first-use builder for one CUDA source with a C interface."""

    NAME = "base"
    SOURCE = ""  # path under deepspeed_tpu_torch/
    _locks: Dict[str, threading.Lock] = {}  # one per source: sources build in parallel
    _locks_guard = threading.Lock()

    def nvcc_flags(self) -> List[str]:
        return ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                "-shared", "-Xcompiler", "-fPIC"]

    def source_path(self) -> str:
        return os.path.join(_PKG_ROOT, self.SOURCE)

    def lib_path(self) -> str:
        h = hashlib.sha256(" ".join(self.nvcc_flags()).encode())
        headers = sorted(glob.glob(os.path.join(_PKG_ROOT, "csrc", "*.cuh")))
        for path in [self.source_path()] + headers:
            with open(path, "rb") as f:
                h.update(f.read())
        return os.path.join(_BUILD_DIR, f"lib{self.NAME}-{h.hexdigest()[:16]}.so")

    def build(self, verbose: bool = False) -> str:
        """Path of the built library, compiling it first if needed.
        ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and spills
        of each kernel) and logs the compiler's output."""
        with CUDAOpBuilder._locks_guard:
            lock = CUDAOpBuilder._locks.setdefault(self.NAME, threading.Lock())
        with lock:
            out = self.lib_path()
            if os.path.exists(out) and not verbose:
                return out
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = ([find_nvcc()] + self.nvcc_flags()
                   + (["-Xptxas", "-v"] if verbose else [])
                   + [self.source_path(), "-o", tmp])
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {self.SOURCE} "
                                   f"(exit {proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
            msg = f"built {os.path.basename(out)} in {time.perf_counter() - t0:.1f} s"
            logger.info(msg + (f"\n{proc.stderr}" if verbose else ""))
            return out

    def load(self, verbose: bool = False) -> ctypes.CDLL:
        return ctypes.CDLL(self.build(verbose=verbose))


class PagedAttentionBuilder(CUDAOpBuilder):
    NAME = "paged_attention"
    SOURCE = os.path.join("csrc", "paged_attention.cu")


class FlashAttentionBuilder(CUDAOpBuilder):
    NAME = "flash_attention"
    SOURCE = os.path.join("csrc", "flash_attention.cu")


class WoqGemmBuilder(CUDAOpBuilder):
    NAME = "woq_gemm"
    SOURCE = os.path.join("csrc", "woq_gemm.cu")


class BlockSparseAttentionBuilder(CUDAOpBuilder):
    NAME = "block_sparse_attention"
    SOURCE = os.path.join("csrc", "block_sparse_attention.cu")


class FusedCEBuilder(CUDAOpBuilder):
    NAME = "fused_ce"
    SOURCE = os.path.join("csrc", "fused_ce.cu")


ALL_BUILDERS = (PagedAttentionBuilder, FlashAttentionBuilder, WoqGemmBuilder,
                BlockSparseAttentionBuilder, FusedCEBuilder)


def _cpu_identity() -> bytes:
    """The CPU's model name and feature flags (``/proc/cpuinfo``): a library
    built with ``-march=native`` on one machine is not loaded on another."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith((b"model name", b"flags"))]
    return b"\n".join(dict.fromkeys(keep))


class HostOpBuilder:
    """Compile-on-first-use builder for one host C++ source with a C
    interface. A missing compiler raises: the engine has no Python stand-in
    for a host library."""

    NAME = "base"
    SOURCE = ""  # path under deepspeed_tpu_torch/
    _locks: Dict[str, threading.Lock] = {}
    _locks_guard = threading.Lock()

    def cxx_flags(self) -> List[str]:
        return ["-O3", "-std=c++17", "-fPIC", "-shared", "-march=native", "-fopenmp"]

    def libraries_args(self) -> List[str]:
        return []

    def source_path(self) -> str:
        return os.path.join(_PKG_ROOT, self.SOURCE)

    def lib_path(self) -> str:
        h = hashlib.sha256(" ".join(self.cxx_flags() + self.libraries_args()).encode())
        h.update(_cpu_identity())
        with open(self.source_path(), "rb") as f:
            h.update(f.read())
        return os.path.join(_BUILD_DIR, f"lib{self.NAME}-{h.hexdigest()[:16]}.so")

    def build(self, verbose: bool = False) -> str:
        """Path of the built library, compiling it first if needed."""
        with HostOpBuilder._locks_guard:
            lock = HostOpBuilder._locks.setdefault(self.NAME, threading.Lock())
        with lock:
            out = self.lib_path()
            if os.path.exists(out):
                return out
            cxx = shutil.which("g++")
            if cxx is None:
                raise RuntimeError(f"g++ not found: the host library {self.NAME} is built "
                                   "from source at first use")
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
            cmd = ([cxx] + self.cxx_flags() + [self.source_path(), "-o", tmp]
                   + self.libraries_args())
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for {self.SOURCE} "
                                   f"(exit {proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, out)
            msg = f"built {os.path.basename(out)} in {time.perf_counter() - t0:.1f} s"
            logger.info(msg + (f"\n{proc.stderr}" if verbose else ""))
            return out

    def load(self, verbose: bool = False) -> ctypes.CDLL:
        return ctypes.CDLL(self.build(verbose=verbose))


class CPUAdamBuilder(HostOpBuilder):
    """The host Adam of ZeRO-Offload (``csrc/cpu_adam.cpp``, a copy of the
    repository's ``csrc/adam/cpu_adam.cpp``)."""

    NAME = "cpu_adam"
    SOURCE = os.path.join("csrc", "cpu_adam.cpp")


class AsyncIOBuilder(HostOpBuilder):
    """The threaded async I/O of the NVMe tier (``csrc/aio.cpp``, a copy of
    the repository's ``csrc/aio/aio.cpp``)."""

    NAME = "aio"
    SOURCE = os.path.join("csrc", "aio.cpp")

    def libraries_args(self) -> List[str]:
        return ["-lpthread"]


HOST_BUILDERS = (CPUAdamBuilder, AsyncIOBuilder)


def build_all(verbose: bool = False) -> List[str]:
    """Build every kernel source and host library, one compiler process per
    source, all started together; returns the libraries' paths."""
    from concurrent.futures import ThreadPoolExecutor

    builders = ALL_BUILDERS + HOST_BUILDERS
    with ThreadPoolExecutor(len(builders)) as pool:
        return list(pool.map(lambda b: b().build(verbose=verbose), builders))

