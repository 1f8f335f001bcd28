"""Fused first-order linear recurrence ``h_t = a_t * h_{t-1} + x_t``,
``h_{-1} = 0``: the inner loop of RG-LRU.

Counterpart of ``repro/kernels/linear_scan.py``.  a, x: (B, S, W) f32 ->
h: (B, S, W) f32, for any B, S >= 1 and W.

Source note.  :func:`linear_scan_kernel` launches ``csrc/linear_scan.cu``
and replaces the Pallas TPU kernel
``repro/kernels/linear_scan.py::linear_scan_kernel`` (with its padded
wrapper ``linear_scan``).  It is bound by bytes: 12 bytes moved and two
flops per step.  One thread walks one (b, w) channel in order of t, with
(64 steps x 32 channels) tiles of a and x staged in shared memory by
``cp.async``, two stages deep, and h carried in a register across tiles.
The step is an f32 multiply rounded, then an add rounded -- never an FMA
-- so the kernel is bit-identical to :func:`linear_scan_plain`, which the
CPU path and the kernel's on-card check use.  A chunked parallel scan
would change the order of operations and is not used.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["linear_scan_plain", "linear_scan_kernel"]


def linear_scan_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a, x: (B, S, W) -> h: (B, S, W) f32, one step per t: ``a_t * h``
    rounded to f32, then ``+ x_t`` rounded (two operations, no FMA)."""
    a32, x32 = a.float(), x.float()
    B, S, W = a32.shape
    out = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    h = torch.zeros((B, W), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = a32[:, t] * h + x32[:, t]
        out[:, t] = h
    return out


@functools.cache
def _entry():
    lib = build.load("linear_scan")
    fn = lib.linear_scan
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def linear_scan_kernel(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: the contract of :func:`linear_scan_plain` on
    contiguous float32 CUDA tensors of one shape (B, S, W), bit-identical
    to it."""
    if not (a.is_cuda and x.device == a.device):
        raise ValueError("linear_scan_kernel takes CUDA tensors on one "
                         "device")
    if a.dtype != torch.float32 or x.dtype != torch.float32:
        raise ValueError(f"linear_scan_kernel takes float32, not {a.dtype}, "
                         f"{x.dtype}")
    if a.ndim != 3 or x.shape != a.shape:
        raise ValueError(f"bad shapes: a {tuple(a.shape)}, x "
                         f"{tuple(x.shape)}")
    if not (a.is_contiguous() and x.is_contiguous()):
        raise ValueError("linear_scan_kernel needs contiguous inputs")
    B, S, W = a.shape
    out = torch.empty_like(a)
    lib, fn = _entry()
    err = fn(a.data_ptr(), x.data_ptr(), out.data_ptr(), B, S, W,
             torch.cuda.current_stream(a.device).cuda_stream)
    build.check(lib, "linear_scan", err)
    linear_scan_kernel.launches += 1
    return out


linear_scan_kernel.launches = 0
