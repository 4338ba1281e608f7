"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into ``build/repro_torch_kernels/<name>-<hash>.so`` at the root of the
checkout, where the hash covers the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  ``build_all``
starts one ``nvcc`` per source at once and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA "
                       "toolkit's nvcc (set CUDA_HOME or put nvcc on PATH)")


def _tmp(target: Path) -> Path:
    return target.with_suffix(f".{os.getpid()}.tmp")


class CudaKernel:
    """One ``csrc/<name>.cu`` library: built once, loaded once, launches counted.

    ``launches`` counts the wrapper's calls that launched this kernel; the
    wrapper adds one after each launch that returned without error.
    """

    def __init__(self, name: str, signatures: dict):
        self.name = name
        self.signatures = signatures  # C function -> ctypes argtypes
        self.launches = 0
        self.ptxas_log = ""
        self._lib = None

    @property
    def source(self) -> Path:
        return CSRC / f"{self.name}.cu"

    def _target(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for extra in sorted(CSRC.glob("*.cuh")):
            h.update(extra.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def start_build(self):
        """Start nvcc for this source; returns the process, or None if built."""
        target = self._target()
        if target.exists():
            log = target.with_suffix(".log")
            self.ptxas_log = log.read_text() if log.exists() else ""
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(_tmp(target)),
               str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)

    def finish_build(self, proc) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source} "
                               f"(exit {proc.returncode}):\n{out}")
        target = self._target()
        target.with_suffix(".log").write_text(out)
        os.replace(_tmp(target), target)  # atomic: a concurrent build loads either
        self.ptxas_log = out

    def lib(self):
        if self._lib is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self._target()))
            for fn, argtypes in self.signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def check(self, err: int) -> None:
        """Raise on a non-zero cudaError_t returned by a launch."""
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with cudaError_t {err}")

    def resources(self) -> dict:
        """{function: {registers, static_smem, spill_stores}} from ``-Xptxas -v``."""
        rows, fn = {}, None
        for line in self.ptxas_log.splitlines():
            m = re.search(r"(?:Compiling entry function '|Function properties for )(\w+)",
                          line)
            if m:
                fn = m.group(1)
                rows.setdefault(fn, {"registers": None, "static_smem": 0,
                                     "spill_stores": 0})
                continue
            if fn is None:
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                rows[fn]["spill_stores"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rows[fn]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                rows[fn]["static_smem"] = int(m.group(1))
        return rows


class KernelEntry:
    """Another entry point of a ``CudaKernel``'s library, with a launch count
    of its own; the library is built and loaded once, by that kernel."""

    def __init__(self, name: str, kernel: CudaKernel):
        self.name, self.kernel = name, kernel
        self.launches = 0

    @property
    def source(self) -> Path:
        return self.kernel.source


def build_all(kernels) -> float:
    """Build every kernel's source in parallel (one nvcc each); seconds taken."""
    t0 = time.perf_counter()
    procs = [(k, k.start_build()) for k in kernels]
    for k, p in procs:
        k.finish_build(p)
    for k in kernels:
        k.lib()
    return time.perf_counter() - t0


def check_cuda_tensor(name: str, t, dtype=None) -> None:
    """The checks every wrapper makes before passing a pointer to a kernel."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in its last dim, strides {t.stride()}")
