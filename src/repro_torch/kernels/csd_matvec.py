"""CSD digit-plane shift-add matvec: the bit-exact ASIC datapath.

Counterpart of ``repro/kernels/csd_matvec.py``.  The paper's multiplierless
designs (Section V) evaluate ``y = x @ W`` as planes of +-shifted adds over
the CSD digits of W: W expanded into D digit planes p_d in {-1, 0, 1},
``y = sum_d (x @ p_d) << d``, exact in int32 (wrapping like the reference's
int32).  Two kernels:

* ``csd_matvec``: one network, (M, K) activations x (D, K, N) planes, the
  dense tail layers of the mutation engine (``repro_torch.eval``);
* ``csd_qsweep``: the sweep mode (DESIGN.md 11.4), Q stacked networks,
  (Q, M, K) x (Q, D, K, N), every q level of a sweep in one launch.

Source note.  :func:`csd_matvec_kernel` and :func:`csd_qsweep_kernel`
launch ``csrc/csd_matvec.cu`` and replace the Pallas TPU kernels
``repro/kernels/csd_matvec.py::csd_matvec_kernel`` and
``::csd_qsweep_kernel``.  They are bound by bytes (x read once, y written
once; the planes are tiny).  Both combine planes into weights, ``sum_d
p_d << d`` in uint32, in shared memory, so the loop over d runs once per
weight.  ``csd_matvec``'s ``"streaming"`` route, which
:func:`route_matvec` picks wherever the combined weights and the tiles fit
(every dense-tail layer of the paper's structures), is a persistent kernel
for one network of many rows: each block combines the weights once, then
streams 128-row tiles of x through a 3-stage ring of bulk copies and
stores each tile's y as one bulk copy, one row a thread.  Its ``"planes"``
route (and ``csd_qsweep``'s ``"chunked"`` one) stages a (K-chunk, N-tile)
of weights a block; each thread owns one output column of up to 4 rows and
reads x from global memory.  ``csd_qsweep``'s
``"resident"`` route, which :func:`route` picks wherever a q's whole
weight matrix and a 64-row tile fit a block's shared memory (every layer
of the paper's sweeps), is a kernel of its own for the sweep's small
shapes: a block takes 64 rows of one q, copies their x and the q's
planes (each one contiguous run) into shared memory together by
``cp.async``, combines the q's weights there, takes one row and 4 columns
a thread, and stores y as one contiguous run (the source's note says
more).  ``csd_qsweep_kernel.launches`` and ``csd_matvec_kernel.launches``
count every launch, their ``route_launches`` those of each route.
:func:`csd_matvec_plain` and :func:`csd_qsweep_plain` are the same
functions in plain PyTorch, per-plane float64 products (exact below 2^53)
reduced modulo 2^32; the CPU path and the kernels' on-card checks use
them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["csd_matvec_plain", "csd_qsweep_plain", "csd_matvec_kernel",
           "csd_qsweep_kernel", "route", "ROUTES", "route_matvec",
           "MATVEC_ROUTES"]
# ``csd_matvec``, the reference's module-level name, is the dispatching op
# of ``ops.py``, which binds it into this module.

_MASK32 = 0xFFFFFFFF
_MAX_DEPTH = 64      # int64 weights have at most 62 CSD digits
ROUTES = ("resident", "chunked")
RESIDENT_ROWS = 64              # csrc/csd_matvec.cu's kResRows
RESIDENT_SMEM = 48 * 1024       # bytes the resident route may use a block
MATVEC_ROUTES = ("streaming", "planes")
STREAM_ROWS, STREAM_STAGES = 128, 3     # csrc/csd_matvec.cu's kStream*
STREAM_SMEM = 112 * 1024        # bytes a streaming block may use: two an SM


def csd_qsweep_plain(x: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """x: (Q, M, K) integer activations; planes: (Q, D, K, N) digits.
    Returns ``sum_d (x[q] @ planes[q, d]) << d`` as (Q, M, N) int32, with
    int32's wraparound."""
    Q, M, K = x.shape
    N = planes.shape[3]
    xf = x.to(torch.float64)
    acc = torch.zeros((Q, M, N), dtype=torch.int64, device=x.device)
    for d in range(min(planes.shape[1], 32)):   # d >= 32 adds 0 mod 2^32
        s = torch.matmul(xf, planes[:, d].to(torch.float64)).to(torch.int64)
        acc += ((s & _MASK32) << d) & _MASK32   # < 2^63: no int64 overflow
    acc &= _MASK32
    return torch.where(acc > 0x7FFFFFFF, acc - (1 << 32), acc).to(torch.int32)


def csd_matvec_plain(x: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """x: (M, K); planes: (D, K, N).  Returns (M, N) int32."""
    return csd_qsweep_plain(x[None], planes[None])[0]


def route(K: int, N: int) -> str:
    """``csd_qsweep``'s route: ``"resident"`` where a q's (K, N) weights
    (uint32, rows padded to 4 columns), a 64-row tile of x and y and 32
    (K, N) planes of int8 fit in 48 KB of shared memory, ``"chunked"``
    (``csd_matvec``'s kernel) elsewhere."""
    smem = 4 * (K * 4 * -(-N // 4) + RESIDENT_ROWS * (K + N)) + 32 * K * N
    return "resident" if smem <= RESIDENT_SMEM else "chunked"


def route_matvec(K: int, N: int) -> str:
    """``csd_matvec``'s route: ``"streaming"`` where the (K, N) weights
    (uint32, rows padded to 4 columns), 3 stages of a 128-row tile of x and
    two of y fit in 112 KB of shared memory, ``"planes"`` elsewhere."""
    smem = 64 + 4 * (K * 4 * -(-N // 4)
                     + STREAM_STAGES * (STREAM_ROWS * K + 8)
                     + 2 * STREAM_ROWS * N)
    return "streaming" if smem <= STREAM_SMEM else "planes"


@functools.cache
def _entry(name: str):
    lib = build.load("csd_matvec")
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(x: torch.Tensor, planes: torch.Tensor, what: str) -> None:
    if not x.is_cuda or planes.device != x.device:
        raise ValueError(f"{what} takes CUDA tensors on one device")
    if x.dtype != torch.int32 or planes.dtype != torch.int8:
        raise ValueError(f"{what} takes int32 x and int8 planes, got "
                         f"{x.dtype} and {planes.dtype}")
    if not (x.is_contiguous() and planes.is_contiguous()):
        raise ValueError(f"{what} needs contiguous tensors")


def _launch(name, x, planes, out, dims):
    lib, fn = _entry(name)
    err = fn(x.data_ptr(), planes.data_ptr(), out.data_ptr(), *dims,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, name, err)


def csd_matvec_kernel(x: torch.Tensor, planes: torch.Tensor, *,
                      how: str | None = None) -> torch.Tensor:
    """The CUDA kernel: the contract of :func:`csd_matvec_plain`, bit
    identical to it.  x (M, K) int32 and planes (D, K, N) int8, contiguous
    on one CUDA device; any M, K, N and 1 <= D <= 64.  The route is
    :func:`route_matvec`'s, or ``how`` (the tests reach both with it)."""
    _check(x, planes, "csd_matvec_kernel")
    (M, K), (D, K2, N) = x.shape, planes.shape
    if K2 != K or not 1 <= D <= _MAX_DEPTH:
        raise ValueError(f"bad shapes: x {tuple(x.shape)}, planes "
                         f"{tuple(planes.shape)}")
    how = how or route_matvec(K, N)
    if how not in MATVEC_ROUTES:
        raise ValueError(f"route must be one of {MATVEC_ROUTES}, not "
                         f"{how!r}")
    out = torch.empty((M, N), dtype=torch.int32, device=x.device)
    _launch("csd_matvec", x, planes, out,
            (M, K, N, D, MATVEC_ROUTES.index(how)))
    csd_matvec_kernel.launches += 1
    csd_matvec_kernel.route_launches[how] += 1
    return out


def csd_qsweep_kernel(x: torch.Tensor, planes: torch.Tensor, *,
                      how: str | None = None) -> torch.Tensor:
    """The CUDA kernel: the contract of :func:`csd_qsweep_plain`, bit
    identical to it.  x (Q, M, K) int32 and planes (Q, D, K, N) int8,
    contiguous on one CUDA device.  The route is :func:`route`'s, or
    ``how`` (the tests reach both routes with it)."""
    _check(x, planes, "csd_qsweep_kernel")
    (Q, M, K), (Q2, D, K2, N) = x.shape, planes.shape
    if Q2 != Q or K2 != K or not 1 <= D <= _MAX_DEPTH:
        raise ValueError(f"bad shapes: x {tuple(x.shape)}, planes "
                         f"{tuple(planes.shape)}")
    how = how or route(K, N)
    if how not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, not {how!r}")
    out = torch.empty((Q, M, N), dtype=torch.int32, device=x.device)
    _launch("csd_qsweep_resident" if how == "resident" else "csd_qsweep", x,
            planes, out, (Q, M, K, N, D))
    csd_qsweep_kernel.launches += 1
    csd_qsweep_kernel.route_launches[how] += 1
    return out


csd_matvec_kernel.launches = 0
csd_matvec_kernel.route_launches = dict.fromkeys(MATVEC_ROUTES, 0)
csd_qsweep_kernel.launches = 0
csd_qsweep_kernel.route_launches = dict.fromkeys(ROUTES, 0)
