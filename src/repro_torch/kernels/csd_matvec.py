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
launch the two entry points of ``csrc/csd_matvec.cu`` and replace the
Pallas TPU kernels ``repro/kernels/csd_matvec.py::csd_matvec_kernel`` and
``::csd_qsweep_kernel``.  They are bound by bytes (x read once, y written
once; the planes are tiny).  Each block first combines the planes of its
(K-chunk, N-tile) into weights, ``sum_d p_d << d`` in uint32, in shared
memory: the loop over d runs once per weight, while staging.  Each thread
then owns one output column of up to 4 rows and takes K multiply-adds per
output, reading x from global memory (the source's note says more).  :func:`csd_matvec_plain` and
:func:`csd_qsweep_plain` are the same functions in plain PyTorch, per-plane
float64 products (exact below 2^53) reduced modulo 2^32; the CPU path and
the kernels' on-card checks use them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["csd_matvec_plain", "csd_qsweep_plain", "csd_matvec_kernel",
           "csd_qsweep_kernel"]

_MASK32 = 0xFFFFFFFF
_MAX_DEPTH = 64      # int64 weights have at most 62 CSD digits


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


@functools.cache
def _entry(name: str):
    lib = build.load("csd_matvec")
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] \
        + [ctypes.c_int] * (5 if name == "csd_qsweep" else 4) \
        + [ctypes.c_void_p]
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


def csd_matvec_kernel(x: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: the contract of :func:`csd_matvec_plain`, bit
    identical to it.  x (M, K) int32 and planes (D, K, N) int8, contiguous
    on one CUDA device; any M, K, N and 1 <= D <= 64."""
    _check(x, planes, "csd_matvec_kernel")
    (M, K), (D, K2, N) = x.shape, planes.shape
    if K2 != K or not 1 <= D <= _MAX_DEPTH:
        raise ValueError(f"bad shapes: x {tuple(x.shape)}, planes "
                         f"{tuple(planes.shape)}")
    out = torch.empty((M, N), dtype=torch.int32, device=x.device)
    _launch("csd_matvec", x, planes, out, (M, K, N, D))
    csd_matvec_kernel.launches += 1
    return out


def csd_qsweep_kernel(x: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: the contract of :func:`csd_qsweep_plain`, bit
    identical to it.  x (Q, M, K) int32 and planes (Q, D, K, N) int8,
    contiguous on one CUDA device."""
    _check(x, planes, "csd_qsweep_kernel")
    (Q, M, K), (Q2, D, K2, N) = x.shape, planes.shape
    if Q2 != Q or K2 != K or not 1 <= D <= _MAX_DEPTH:
        raise ValueError(f"bad shapes: x {tuple(x.shape)}, planes "
                         f"{tuple(planes.shape)}")
    out = torch.empty((Q, M, N), dtype=torch.int32, device=x.device)
    _launch("csd_qsweep", x, planes, out, (Q, M, K, N, D))
    csd_qsweep_kernel.launches += 1
    return out


csd_matvec_kernel.launches = 0
csd_qsweep_kernel.launches = 0
