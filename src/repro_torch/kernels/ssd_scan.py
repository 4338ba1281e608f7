"""Mamba-2 SSD chunk scan on Hopper: wrapper of ``csrc/ssd_scan.cu``.

Counterpart of ``repro.kernels.ssd_scan`` (the Pallas TPU kernel
``_ssd_kernel``).  The wrapper checks its inputs, allocates y and the final
state and launches the kernel on the current stream; it never runs the
plain version (``ops.ssd`` sends CPU tensors to ``ref.ssd_chunked``).  Unlike
the TPU kernel it takes ``h_init`` and a sequence length that is not a
multiple of the chunk itself, so there is no fallback.  One call launches
up to four CUDA kernels (``csrc/ssd_scan.cu``; the state and combine passes
only where the plan has several segments) on scratch it allocates here, and
counts as one launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels._build import CudaKernel, check_cuda_tensor

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
KERNEL = CudaKernel("ssd_scan", {
    "repro_ssd_scan_fwd": [_P] * 9 + [_L] + [_I] * 9 + [_L] * 21 + [_I, _P],
    "repro_ssd_scan_plan": [_I] * 8 + [ctypes.POINTER(_I)] * 2 + [ctypes.POINTER(_L)],
    "repro_ssd_scan_smem_bytes": [_I],
    "repro_ssd_scan_limits": [ctypes.POINTER(_I)] * 3,
})


def limits() -> dict:
    """The largest chunk, head width P and state width N the kernel takes."""
    vals = [_I() for _ in range(3)]
    KERNEL.lib().repro_ssd_scan_limits(*(ctypes.byref(v) for v in vals))
    return dict(zip(("chunk", "p", "n"), (v.value for v in vals)))


class Plan(NamedTuple):
    segments: int
    chunks_per_segment: int
    workspace_floats: int


@functools.lru_cache(maxsize=None)
def plan(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int, device: int = 0) -> Plan:
    """How the kernel splits a shape on a device, computed once per shape and
    device; ``ssd_scan`` launches with it."""
    nseg, cps, ws = _I(), _I(), _L()
    KERNEL.check(KERNEL.lib().repro_ssd_scan_plan(b, s, h, p, g, n, chunk, device,
                                                   ctypes.byref(nseg), ctypes.byref(cps),
                                                   ctypes.byref(ws)))
    return Plan(nseg.value, cps.value, ws.value)


def ssd_scan(x, dt, a, b_mat, c_mat, chunk: int, h_init=None):
    """CUDA kernel.  x [B,S,H,P], dt [B,S,H], a [H], b/c [B,S,G,N], h_init
    [B,H,P,N] or None, all f32 -> (y [B,S,H,P], final state [B,H,P,N]), f32.

    S need not be a multiple of ``chunk``: positions past S are masked as
    zero-padding with dt = 0, which is how ``ref.ssd_chunked`` pads them.
    """
    f32 = torch.float32
    named = [("x", x, 4), ("dt", dt, 3), ("a", a, 1), ("b_mat", b_mat, 4), ("c_mat", c_mat, 4)]
    if h_init is not None:
        named.append(("h_init", h_init, 4))
    for name, t, nd in named:
        check_cuda_tensor(name, t, f32)
        if t.dim() != nd:
            raise ValueError(f"{name} must be {nd}-D, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError("all inputs must be on one device")
    b, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if (dt.shape != (b, s, h) or a.shape != (h,) or b_mat.shape[:2] != (b, s)
            or c_mat.shape != b_mat.shape or g == 0 or h % g
            or (h_init is not None and h_init.shape != (b, h, p, n))):
        raise ValueError(f"shapes x {tuple(x.shape)} dt {tuple(dt.shape)} a {tuple(a.shape)} "
                         f"b {tuple(b_mat.shape)} c {tuple(c_mat.shape)}"
                         + (f" h_init {tuple(h_init.shape)}" if h_init is not None else ""))
    lim = limits()
    if not (4 <= chunk <= lim["chunk"] and chunk % 4 == 0 and 1 <= p <= lim["p"]
            and 1 <= n <= lim["n"]):
        raise ValueError(f"chunk {chunk}, P {p}, N {n}: the kernel takes a chunk that is a "
                         f"multiple of 4 up to {lim['chunk']}, P up to {lim['p']} and N up to "
                         f"{lim['n']}")
    y = torch.empty((b, s, h, p), dtype=f32, device=x.device)
    st = torch.empty((b, h, p, n), dtype=f32, device=x.device)
    pl = plan(b, s, h, p, g, n, chunk, x.device.index or 0)
    ws = torch.empty((pl.workspace_floats,), dtype=f32, device=x.device)
    hs = h_init.stride()[:3] if h_init is not None else (0, 0, 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = KERNEL.lib().repro_ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
        h_init.data_ptr() if h_init is not None else None, y.data_ptr(), st.data_ptr(),
        ws.data_ptr(), pl.workspace_floats, b, s, h, p, g, n, chunk, pl.segments,
        pl.chunks_per_segment,
        *x.stride()[:3], *dt.stride(), *b_mat.stride()[:3], *c_mat.stride()[:3],
        *y.stride()[:3], *hs, *st.stride()[:3], x.device.index or 0, stream)
    KERNEL.check(err)
    KERNEL.launches += 1
    return y, st
