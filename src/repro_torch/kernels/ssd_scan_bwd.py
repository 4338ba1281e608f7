"""Gradient of the Mamba-2 SSD chunk scan on Hopper: wrapper of ``csrc/ssd_scan_bwd.cu``.

Counterpart of the backward of ``repro.kernels.ssd_scan``'s custom VJP
(``_ssd_vjp_bwd``, which XLA recomputes through the oracle's VJP).  The
wrapper checks its inputs, allocates the gradients and the scratch and
launches the kernel on the current stream; it never runs the plain version
(``ops.ssd_bwd`` sends CPU tensors to ``ref.ssd_chunked_bwd``).  It takes
the forward's inputs, not its residuals: the kernel recomputes the states
entering each chunk.  One call launches the kernel's passes
(``csrc/ssd_scan_bwd.cu``: the walks over segments of chunks, the combine
over the segments' boundaries where the plan has several, the per-chunk
gradients, the group sum of dB and dC, da) and counts as one launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels._build import CudaKernel, check_cuda_tensor

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
KERNEL = CudaKernel("ssd_scan_bwd", {
    "repro_ssd_scan_bwd": [_P] * 15 + [_L] + [_I] * 7 + [_L] * 21 + [_I, _P],
    "repro_ssd_scan_bwd_workspace": [_I] * 7 + [ctypes.POINTER(_L)],
    "repro_ssd_scan_bwd_plan": [_I] * 8 + [ctypes.POINTER(_I)] * 2,
    "repro_ssd_scan_bwd_smem_bytes": [_I],
    "repro_ssd_scan_bwd_limits": [ctypes.POINTER(_I)] * 3,
})


def limits() -> dict:
    """The largest chunk, head width P and state width N the kernel takes."""
    vals = [_I() for _ in range(3)]
    KERNEL.lib().repro_ssd_scan_bwd_limits(*(ctypes.byref(v) for v in vals))
    return dict(zip(("chunk", "p", "n"), (v.value for v in vals)))


class Plan(NamedTuple):
    segments: int
    chunks_per_segment: int


@functools.lru_cache(maxsize=None)
def plan(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int, device: int = 0) -> Plan:
    """How the kernel cuts a shape's chunks into segments on a device (pass 1
    walks each segment with 2 * b * h blocks); ``ssd_scan_bwd`` chooses the
    same plan inside its call."""
    nseg, cps = _I(), _I()
    KERNEL.check(KERNEL.lib().repro_ssd_scan_bwd_plan(b, s, h, p, g, n, chunk, device,
                                                      ctypes.byref(nseg), ctypes.byref(cps)))
    return Plan(nseg.value, cps.value)


def ssd_scan_bwd(x, dt, a, b_mat, c_mat, chunk: int, dy, dstate, h_init=None):
    """CUDA kernel.  The forward's inputs x [B,S,H,P], dt [B,S,H], a [H], b/c
    [B,S,G,N], h_init [B,H,P,N] or None and the cotangents dy [B,S,H,P] and
    dstate [B,H,P,N] of its outputs, all f32 -> (dx, ddt, da, db, dc,
    dh_init), f32, contiguous; dh_init is None where h_init is.

    S need not be a multiple of ``chunk``: positions past S are masked as
    zero-padding with dt = 0, as ``ref.ssd_chunked`` pads them.
    """
    f32 = torch.float32
    named = [("x", x, 4), ("dt", dt, 3), ("a", a, 1), ("b_mat", b_mat, 4), ("c_mat", c_mat, 4),
             ("dy", dy, 4), ("dstate", dstate, 4)]
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
            or c_mat.shape != b_mat.shape or g == 0 or h % g or dy.shape != x.shape
            or dstate.shape != (b, h, p, n)
            or (h_init is not None and h_init.shape != (b, h, p, n))):
        raise ValueError(f"shapes x {tuple(x.shape)} dt {tuple(dt.shape)} a {tuple(a.shape)} "
                         f"b {tuple(b_mat.shape)} c {tuple(c_mat.shape)} dy {tuple(dy.shape)} "
                         f"dstate {tuple(dstate.shape)}"
                         + (f" h_init {tuple(h_init.shape)}" if h_init is not None else ""))
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")
    lim = limits()
    if not (4 <= chunk <= lim["chunk"] and chunk % 4 == 0 and 1 <= p <= lim["p"]
            and 1 <= n <= lim["n"]):
        raise ValueError(f"chunk {chunk}, P {p}, N {n}: the kernel takes a chunk that is a "
                         f"multiple of 4 up to {lim['chunk']}, P up to {lim['p']} and N up to "
                         f"{lim['n']}")
    dev = x.device
    dx = torch.empty((b, s, h, p), dtype=f32, device=dev)
    ddt = torch.empty((b, s, h), dtype=f32, device=dev)
    da = torch.empty((h,), dtype=f32, device=dev)
    db = torch.empty((b, s, g, n), dtype=f32, device=dev)
    dc = torch.empty((b, s, g, n), dtype=f32, device=dev)
    dh0 = torch.empty((b, h, p, n), dtype=f32, device=dev) if h_init is not None else None
    floats = _L()
    lib = KERNEL.lib()
    KERNEL.check(lib.repro_ssd_scan_bwd_workspace(b, s, h, p, g, n, chunk,
                                                  ctypes.byref(floats)))
    ws = torch.empty((max(floats.value, 4),), dtype=f32, device=dev)
    hs = h_init.stride()[:3] if h_init is not None else (0, 0, 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.repro_ssd_scan_bwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
        h_init.data_ptr() if h_init is not None else None, dy.data_ptr(), dstate.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
        dh0.data_ptr() if dh0 is not None else None, ws.data_ptr(), ws.numel(),
        b, s, h, p, g, n, chunk,
        *x.stride()[:3], *dt.stride(), *b_mat.stride()[:3], *c_mat.stride()[:3],
        *dy.stride()[:3], *hs, *dstate.stride()[:3], dev.index or 0, stream)
    KERNEL.check(err)
    KERNEL.launches += 1
    return dx, ddt, da, db, dc, dh0
