"""The RWKV6 time mix's WKV recurrence over one layer's sequence.

Per (batch row b, head h) the state s is an (hd, hd) f32 matrix, rows i
on the key axis and columns j on the value axis, and each step t does::

    kv_ij  = k_i v_j
    out_j  = sum_i r_i (s_ij + u_i kv_ij)     (from the state before t)
    s_ij  <- w_i s_ij + kv_ij

r, k, v, w: (B, S, H, hd) f32; u: (H, hd) f32; s0: (B, H, hd, hd) f32 ->
y (B, S, H, hd) f32 and the final state (B, H, hd, hd) f32, for any
B >= 1 and S >= 1 (S = 1 is a decode step from a carried state).

Source note.  :func:`wkv6_kernel` launches ``csrc/wkv6.cu``.  It replaces
no Pallas kernel: the reference runs this recurrence as a ``lax.scan``
over tokens (``repro/nn/blocks.py::rwkv_time_mix_seq``, its ``step``),
its one device loop on the RWKV path, and a token-by-token Python loop
would issue ~6 launches a token and layer.  It is bound by bytes: each
step reads r, k, v, w and writes y (20 bytes a channel), the state is
read and written once a launch, and the work (~5 flops a state entry a
step) is far below the card's rate.  The kernel runs one block of hd
threads per (h, b), thread j keeping column s[:, j] in registers for the
whole sequence; the step's r, k, w (and u) go through shared memory,
double-buffered so one barrier a step suffices, and the next step's
inputs are loaded while the current one computes.  Its launch bounds
ask for one block a multiprocessor, which leaves a thread the registers
for its state column and several shared-memory loads in flight.  Only
B * H chains run (160 at the serving batch), each sequential over S, so
it sits far above its bound; a chunked form on the tensor cores is
later work.

The state update is ``__fadd_rn(__fmul_rn(w_i, s_ij), kv_ij)`` with
``kv_ij`` rounded once -- the plain version's two eager ops -- so the
final state is bit-identical to :func:`wkv6_plain`.  y differs from it
only in the order of the hd-term sum (the kernel adds in i order with
FMAs; the plain version's ``einsum`` is a batched product).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["wkv6_plain", "wkv6_kernel", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 128)   # the head widths the kernel is built for


def wkv6_plain(r, k, v, w, u, s0):
    """The reference's ``step`` in PyTorch, one token at a time: returns
    (y (B, S, H, hd) f32, the final state (B, H, hd, hd) f32)."""
    B, S, H, hd = r.shape
    s = s0.float()
    uu = u.float()[None, :, :, None]                      # key axis i
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]    # (B, H, i, j)
        y[:, t] = torch.einsum("bhk,bhkv->bhv", r[:, t], s + uu * kv)
        s = w[:, t, :, :, None] * s + kv
    return y, s


@functools.cache
def _entry():
    lib = build.load("wkv6")
    fn = lib.wkv6
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def wkv6_kernel(r, k, v, w, u, s0):
    """The CUDA kernel: :func:`wkv6_plain`'s contract on contiguous f32
    CUDA tensors, the final state bit-identical to it.  Raises
    ``ValueError`` on anything else, an hd outside :data:`HEAD_DIMS`
    among it."""
    if not (r.is_cuda and all(t.device == r.device
                              for t in (k, v, w, u, s0))):
        raise ValueError("wkv6_kernel takes CUDA tensors on one device")
    if any(t.dtype != torch.float32 for t in (r, k, v, w, u, s0)):
        raise ValueError("wkv6_kernel takes float32 tensors")
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"r, k, v, w must share one (B, S, H, hd) shape, "
                         f"not {[tuple(t.shape) for t in (r, k, v, w)]}")
    B, S, H, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6_kernel takes hd in {HEAD_DIMS}, not {hd}")
    if B < 1 or S < 1:
        raise ValueError(f"wkv6_kernel takes B >= 1 and S >= 1, not "
                         f"({B}, {S})")
    if tuple(u.shape) != (H, hd) or tuple(s0.shape) != (B, H, hd, hd):
        raise ValueError(f"bad shapes: u {tuple(u.shape)}, s0 "
                         f"{tuple(s0.shape)} for r {tuple(r.shape)}")
    if not all(t.is_contiguous() for t in (r, k, v, w, u, s0)):
        raise ValueError("wkv6_kernel needs contiguous inputs")
    y = torch.empty_like(r)
    sS = torch.empty_like(s0)
    lib, fn = _entry()
    err = fn(*(t.data_ptr() for t in (r, k, v, w, u, s0, y, sS)),
             B, S, H, hd, torch.cuda.current_stream(r.device).cuda_stream)
    build.check(lib, "wkv6", err)
    wkv6_kernel.launches += 1
    return y, sS


wkv6_kernel.launches = 0
