"""What the kernel A/B scripts beside this file share: a kernel built from
another source, the wrapper's call made through another build's library,
rounds of device-time readings with their medians, and the card's name and
power limit.  Each ``*_ab.py`` imports it; it runs nothing of its own.
"""
from __future__ import annotations

import shutil
import statistics
import subprocess
from pathlib import Path


def build_of(path: Path, name: str, signatures: dict, text: str | None = None):
    """A CudaKernel of the source at ``path`` (or of ``text`` in its place),
    built under another name beside a copy of the headers of ``path``'s own
    directory, so that an earlier commit's source meets its own headers."""
    from repro_torch.kernels import _build
    where = _build.BUILD_DIR / name
    where.mkdir(parents=True, exist_ok=True)
    for header in path.parent.glob("*.cuh"):
        shutil.copyfile(header, where / header.name)
    src = where / f"{name}.cu"
    src.write_text(path.read_text() if text is None else text)

    class Other(_build.CudaKernel):
        @property
        def source(self) -> Path:
            return src

    return Other(name, signatures)


def with_lib(kernel, lib, fn):
    """``fn``, a call of ``kernel``'s wrapper, made through ``lib``, another
    build of its library."""
    def call():
        own = kernel.lib()
        kernel._lib = lib
        try:
            return fn()
        finally:
            kernel._lib = own
    return call


def read_rounds(tag: str, calls: dict, order, rounds: int, iters: int, parts=None,
                width: int = 8, digits: int = 4):
    """``rounds`` rounds of the labels in ``order`` (old, new, ..., new, old):
    each reading torch.profiler's device time a call of ``calls[label]`` over
    ``iters`` calls, printed on a line of its own, with each kernel's share
    where ``parts`` shortens the kernels' names.  Returns the readings and
    their medians, by label."""
    import chip_smoke as cs
    readings = {label: [] for label in order}
    for rnd in range(rounds):
        for label in order:
            per = cs.device_ms_by_kernel(calls[label], iters)
            ms = sum(per.values())
            readings[label].append(ms)
            share = (" (" + ", ".join(f"{parts(k)} {v:.{digits}f}" for k, v in per.items())
                     + ")") if parts else ""
            print(f"[{tag}] round {rnd} {label:{width}s} {ms:.{digits}f} ms{share}", flush=True)
    return readings, {label: statistics.median(r) for label, r in readings.items()}


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
