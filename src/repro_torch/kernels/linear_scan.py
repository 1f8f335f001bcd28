"""Fused first-order linear recurrence ``h_t = a_t * h_{t-1} + x_t``,
``h_{-1} = 0``: the inner loop of RG-LRU.

Counterpart of ``repro/kernels/linear_scan.py``.  a, x: (B, S, W) f32 ->
h: (B, S, W) f32, for any B, S >= 1 and W.

Source note.  :func:`linear_scan_kernel` launches ``csrc/linear_scan.cu``
and replaces the Pallas TPU kernel
``repro/kernels/linear_scan.py::linear_scan_kernel`` (with its padded
wrapper ``linear_scan``).  It is bound by bytes: 12 bytes moved and two
flops per step.  One thread walks one (b, w) channel in order of t from
h = 0, on every route, and the step is an f32 multiply rounded, then an
add rounded -- never an FMA -- so every route is bit-identical to
:func:`linear_scan_plain`, which the CPU path and the kernel's on-card
check use.  A chunked parallel scan would change the order of operations
and is not used.

:func:`route` picks one of :data:`ROUTES` from S, W and alignment alone:

- ``"step"`` for ``S <= STEP_MAX_S`` (decode's S = 1) where the rule below
  holds: each thread walks 4 channels' S steps straight from device
  memory with 16-byte loads and stores;
- ``"ring"`` for longer scans where the rule holds: a producer warp keeps
  a 4-stage ring of (64 steps x 32 channels) TMA boxes of a and x in
  flight on mbarriers, a consumer warp walks them with h in registers and
  stores each h tile as one TMA box;
- ``"tiled"`` (the first version: 4-byte ``cp.async`` tiles two stages
  deep) for every other shape.

The rule (:func:`bulk_aligned`): W % 4 == 0 and a, x and h start 16-byte
aligned, as a TMA tensor map and a 16-byte vector need.  W = 70, W = 33
and a view that starts off a 16-byte boundary (a storage offset that
``.contiguous()`` keeps) break it.  A route is chosen by shape and
address, never after a failure: a build or launch failure raises.

The gradient.  The reference differentiates its scan with XLA's autodiff;
the port's forward is a kernel autograd cannot see through, so
:class:`LinearScan` pairs it with :func:`linear_scan_bwd`: the gradient of
``h_t = a_t h_{t-1} + x_t`` is the same first-order recurrence run
backward in time, ``g_t = dh_t + a_{t+1} g_{t+1}``, so the forward kernel
computes it on the time-reversed, shifted a and dh (``torch.flip``
copies), and ``dx = g``, ``da_t = g_t h_{t-1}``.  No new kernel source.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["linear_scan_plain", "linear_scan_ref", "linear_scan_kernel",
           "linear_scan_bwd", "LinearScan", "route", "bulk_aligned",
           "ROUTES", "STEP_MAX_S"]
# ``linear_scan``, the reference's module-level name, is the dispatching op
# of ``ops.py``, which binds it into this module.

ROUTES = ("ring", "step", "tiled")   # the C entry's route ids
STEP_MAX_S = 16          # the longest scan the step route walks


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


def linear_scan_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The reference's oracle: its ``lax.scan`` step ``a_t * h + x_t``,
    which XLA's CPU compiler fuses into one multiply-add.  The product of
    two f32 values is exact in f64, so the step is the f64 sum rounded to
    f32 (bit for bit the reference's at its tests' shapes)."""
    a64, x64 = a.double(), x.double()
    B, S, W = a64.shape
    out = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    h = torch.zeros((B, W), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = (a64[:, t] * h.double() + x64[:, t]).float()
        out[:, t] = h
    return out


def bulk_aligned(W: int, *ptrs: int) -> bool:
    """Whether (B, S, W) f32 tensors at these base addresses can move as
    TMA boxes and 16-byte vectors: W % 4 == 0, every address 16-byte
    aligned."""
    return W % 4 == 0 and all(p % 16 == 0 for p in ptrs)


def route(S: int, W: int, *ptrs: int) -> str:
    """The route for a scan of S steps over W channels, with a, x and h at
    base addresses ``ptrs``: ``"tiled"`` where :func:`bulk_aligned`
    fails, else ``"step"`` where ``S <= STEP_MAX_S`` and ``"ring"``
    above."""
    if not bulk_aligned(W, *ptrs):
        return "tiled"
    return "step" if S <= STEP_MAX_S else "ring"


@functools.cache
def _entry():
    lib = build.load("linear_scan")
    fn = lib.linear_scan
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def linear_scan_kernel(a: torch.Tensor, x: torch.Tensor, *,
                       how: str | None = None) -> torch.Tensor:
    """The CUDA kernel: the contract of :func:`linear_scan_plain` on
    contiguous float32 CUDA tensors of one shape (B, S, W), bit-identical
    to it.  The route is :func:`route`'s, or ``how`` (the tests reach
    every route with it; ``"ring"`` and ``"step"`` need
    :func:`bulk_aligned`)."""
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
    ptrs = (a.data_ptr(), x.data_ptr(), out.data_ptr())
    how = how or route(S, W, *ptrs)
    if how not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, not {how!r}")
    if how != "tiled" and not bulk_aligned(W, *ptrs):
        raise ValueError(f"route {how!r} needs W % 4 == 0 and 16-byte "
                         f"aligned tensors")
    lib, fn = _entry()
    err = fn(*ptrs, B, S, W, ROUTES.index(how),
             torch.cuda.current_stream(a.device).cuda_stream)
    build.check(lib, "linear_scan", err)
    linear_scan_kernel.launches += 1
    linear_scan_kernel.route_launches[how] += 1
    return out


linear_scan_kernel.launches = 0
linear_scan_kernel.route_launches = dict.fromkeys(ROUTES, 0)


def linear_scan_bwd(scan, a: torch.Tensor, h: torch.Tensor,
                    dh: torch.Tensor):
    """The backward of ``h = scan(a, x)``: (da, dx) f32 from a, the
    forward's h and dh, all (B, S, W) f32.  With a'_t = a_{t+1} and
    a'_{S-1} = 0, g_t = dh_t + a'_t g_{t+1} is ``scan`` (the kernel or
    :func:`linear_scan_plain`) over the time-reversed a' and dh; dx = g and
    da_t = g_t h_{t-1}, h_{-1} = 0."""
    zero = torch.zeros_like(a[:, :1])
    a_rev = torch.cat([zero, a[:, 1:].flip(1)], dim=1).contiguous()
    g = scan(a_rev, dh.flip(1).contiguous()).flip(1)
    da = g * torch.cat([zero, h[:, :-1]], dim=1)
    return da, g


class LinearScan(torch.autograd.Function):
    """:func:`linear_scan_kernel` under autograd: the forward kernel saving
    a and h, the backward :func:`linear_scan_bwd` on the same kernel.
    ``backward_launches`` counts the backward's kernel launches."""

    backward_launches = 0

    @staticmethod
    def forward(ctx, a, x):
        h = linear_scan_kernel(a, x)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        da, dx = linear_scan_bwd(linear_scan_kernel, a, h, dh.contiguous())
        LinearScan.backward_launches += 1
        return da, dx
