"""int8 x int8 -> int32 matmul with a power-of-two dequant: the paper's
power-of-two weight scales carried to the tensor cores (DESIGN.md 2.4,
"the roofline path").

Counterpart of ``repro/kernels/qmatmul.py`` and ``repro/kernels/ref.py::
qmatmul_ref``: ``y[m, n] = f32(sum_k x[m, k] w[k, n]) * 2^-e[n]`` for x
(M, K) int8, w (K, N) int8 as ``quantize_pot(w, axis=0)`` returns it, e
(N,) int32, an int32 accumulator (wrapping modulo 2^32, as the
reference's int32 does) converted to f32 rounded to nearest even, and an
exact scale ``exp2_int(-e)``.  The output is f32, or the f32 product
rounded to nearest even in bf16 (``out_dtype``).

Source note.  :func:`qmatmul_kernel` launches ``csrc/qmatmul.cu`` and
replaces the Pallas TPU kernel ``repro/kernels/qmatmul.py::
qmatmul_kernel`` (with its padded wrapper ``repro/kernels/ops.py::
qmatmul``).  With f32 output it is bound by the bytes it moves at every
qwen2-0.5b width, prefill-sized M included; only a K = 151936 product at
prefill-sized M is bound by its operations.  The products run on the
int8 tensor cores (``mma.sync.m16n8k32``), exact in int32; each block
stages a 64 x 64 tile of x and of w, the latter transposed, in shared
memory, and zero-fills past M, N and K, so any shape is taken and nothing
is padded (the source's note says more).  The scale is built from
exponent bits, as :func:`~repro_torch.kernels.ops.exp2_int` builds it,
so it is exact where XLA's CPU ``exp2`` is not (``exp2(-13)``,
``exp2(13)``, ...): there the port and the reference differ by the
reference's error.
:func:`qmatmul_plain` is the same function in plain PyTorch; the CPU path
and the kernel's on-card check use it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["qmatmul_plain", "qmatmul_kernel"]

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def qmatmul_plain(x_i8: torch.Tensor, w_i8: torch.Tensor,
                  exp_i32: torch.Tensor,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (M, K), w (K, N) int8 and exp (N,) int32 -> (M, N) ``out_dtype``.

    The product is taken in float64, which is exact: each term is an
    integer of at most 2^14 and every partial sum stays below 2^53 for
    K < 2^39, so any order of summation gives the same integer (torch has
    no int32 matmul on CUDA).  It is then wrapped to int32, as the
    reference's int32 accumulator wraps."""
    from .ops import exp2_int          # ops imports this module
    acc = torch.matmul(x_i8.to(torch.float64), w_i8.to(torch.float64))
    acc = acc.to(torch.int64)
    acc = ((acc + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    y = acc.to(torch.int32).to(torch.float32) * exp2_int(-exp_i32)
    return y.to(out_dtype)


@functools.cache
def _entry():
    lib = build.load("qmatmul")
    fn = lib.qmatmul
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def qmatmul_kernel(x_i8: torch.Tensor, w_i8: torch.Tensor,
                   exp_i32: torch.Tensor, *,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The CUDA kernel: the contract of :func:`qmatmul_plain`, bit
    identical to it, on contiguous CUDA tensors of one device: x (M, K)
    and w (K, N) int8, exp (N,) int32; any M, K, N."""
    ts = (x_i8, w_i8, exp_i32)
    if not (x_i8.is_cuda and all(t.device == x_i8.device for t in ts)):
        raise ValueError("qmatmul_kernel takes CUDA tensors on one device")
    if (x_i8.dtype, w_i8.dtype, exp_i32.dtype) != (torch.int8, torch.int8,
                                                   torch.int32):
        raise ValueError(f"qmatmul_kernel takes int8 x, int8 w and int32 "
                         f"exp, not {x_i8.dtype}, {w_i8.dtype}, "
                         f"{exp_i32.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, not "
                         f"{out_dtype}")
    if (x_i8.ndim != 2 or w_i8.ndim != 2 or w_i8.shape[0] != x_i8.shape[1]
            or exp_i32.shape != (w_i8.shape[1],)):
        raise ValueError(f"bad shapes: x {tuple(x_i8.shape)}, w "
                         f"{tuple(w_i8.shape)}, exp {tuple(exp_i32.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("qmatmul_kernel needs contiguous inputs")
    (M, K), N = x_i8.shape, w_i8.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x_i8.device)
    lib, fn = _entry()
    err = fn(x_i8.data_ptr(), w_i8.data_ptr(), exp_i32.data_ptr(),
             out.data_ptr(), M, N, K, int(out_dtype == torch.bfloat16),
             torch.cuda.current_stream(x_i8.device).cuda_stream)
    build.check(lib, "qmatmul", err)
    qmatmul_kernel.launches += 1
    return out


qmatmul_kernel.launches = 0
