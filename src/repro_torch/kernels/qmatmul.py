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
qwen2-0.5b width (w's at M = 8, mostly the output's at M = 512); only a
K = 151936 product at prefill-sized M is bound by its operations.  The
source holds two routes, and :func:`route` picks one by a plain rule:

* ``"tma"`` -- K > 0, K and N multiples of 16, x and w 16-byte aligned
  (what a TMA tensor map can describe; every qwen2-0.5b width).  Built
  for Hopper: ``wgmma`` takes int8 operands K-major only and w is
  N-major, so each block computes a (128 channels, BM rows) tile
  transposed, y^T = w^T x^T: A is w^T from registers (each thread
  transposes 4 x 4 bytes of w's tile by ``prmt``), B is x's tile as it
  lies; wgmma's N is the M tile (8 to 64), so M = 8 is not padded.  One
  producer warp keeps a 3- or 4-stage TMA ring on mbarriers in flight;
  the consumer warpgroup builds a stage's A fragments, then issues its 8
  products; three blocks share an SM.  Where the output tiles are fewer
  than the SMs, the K walk is split across blocks (:func:`tiling`): each
  split writes its int32 partial to a workspace slice, and the last to
  arrive sums them (wrapping) and finishes.  The epilogue scales 4
  consecutive channels a thread and stores 16 (f32) or 8 (bf16) bytes at
  once, coalesced, with no shared memory.
* ``"mma"`` -- every other shape (a row pitch or base address a tensor
  map cannot take, K = 0): the first version, ``mma.sync.m16n8k32`` on
  64 x 64 tiles with w transposed in registers, zero-filled past M, N and
  K, so any shape is taken.

Nothing is padded by the caller.  The scale is built from exponent bits,
as :func:`~repro_torch.kernels.ops.exp2_int` builds it, so it is exact
where XLA's CPU ``exp2`` is not (``exp2(-13)``, ``exp2(13)``, ...): there
the port and the reference differ by the reference's error.
:func:`qmatmul_plain` is the same function in plain PyTorch; the CPU path
and the kernel's on-card check use it.  ``qmatmul_kernel.launches``
counts every launch, ``qmatmul_kernel.route_launches`` those of each
route.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build

__all__ = ["qmatmul_plain", "qmatmul_kernel", "route", "tiling",
           "Tiling"]
# ``qmatmul``, the reference's module-level name, is the dispatching op
# of ``ops.py``, which binds it into this module.

_OUT_DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("tma", "mma")
SMS = 132                 # the H100's streaming multiprocessors
CHANNELS = 128            # output channels a TMA-route block
K_TILE = 128              # K bytes a TMA-route ring stage
SPLIT_MIN_K_TILES = 5     # k-tiles a split walks at least


class Tiling(NamedTuple):
    """The TMA route's grid: M tiles of ``bm`` rows, 128-channel tiles,
    and K cut into ``split`` parts of ``kt_per`` 128-byte k-tiles."""
    bm: int
    split: int
    kt_per: int


def route(K: int, N: int, x_ptr: int, w_ptr: int) -> str:
    """``"tma"`` where a TMA tensor map describes x (M, K) and w (K, N):
    K > 0, row pitches K and N multiples of 16 bytes, both base addresses
    16-byte aligned; ``"mma"`` otherwise."""
    ok = K > 0 and K % 16 == 0 and N % 16 == 0
    return "tma" if ok and x_ptr % 16 == 0 and w_ptr % 16 == 0 else "mma"


def tiling(M: int, K: int, N: int) -> Tiling:
    """The TMA route's M tile and split of K, from the shape alone.

    ``bm`` is the power of two >= M, from 8 to 64 (wgmma's N), and 32
    where 64 leaves fewer output tiles than ``SMS``: twice the blocks
    repay twice the A fragments a product (PERF.md §6); so 64 is
    never split, and the kernel takes no split at 64.  Where the output
    tiles are still fewer than ``SMS``, K is split into at most
    ``SMS // tiles`` parts (one wave of blocks) of at least
    ``SPLIT_MIN_K_TILES`` k-tiles each, equal in k-tiles and none empty:
    a split costs a workspace slice written and read back and a zeroed
    counter, which shorter walks do not repay (PERF.md §6)."""
    bm = min(64, max(8, 1 << max(0, M - 1).bit_length()))
    if bm == 64 and -(-M // bm) * -(-N // CHANNELS) < SMS:
        bm = 32
    tiles = max(1, -(-M // bm) * -(-N // CHANNELS))
    n_k = max(1, -(-K // K_TILE))
    split = max(1, min(n_k // SPLIT_MIN_K_TILES, SMS // tiles))
    kt_per = -(-n_k // split)
    return Tiling(bm, -(-n_k // kt_per), kt_per)


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
    mma = lib.qmatmul
    mma.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    mma.restype = ctypes.c_int
    tma = lib.qmatmul_tma
    tma.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    tma.restype = ctypes.c_int
    lib.qmatmul_tma_smem.argtypes = [ctypes.c_int]
    lib.qmatmul_tma_smem.restype = ctypes.c_int
    return lib, {"mma": mma, "tma": tma}


def tma_smem_bytes(bm: int) -> int:
    """Dynamic shared memory of a TMA-route block with M tile ``bm``."""
    return _entry()[0].qmatmul_tma_smem(bm)


def launch(x_i8: torch.Tensor, w_i8: torch.Tensor, exp_i32: torch.Tensor,
           out_dtype: torch.dtype, how: str,
           tile: Tiling | None = None) -> torch.Tensor:
    """Launch route ``how`` on inputs :func:`qmatmul_kernel` has checked
    (``how="tma"`` also needs :func:`route`'s conditions), the TMA route
    at ``tile`` (:func:`tiling`'s by default; the tests reach every
    instantiation with it).  Counted in ``qmatmul_kernel.launches`` and
    its route's count."""
    (M, K), N = x_i8.shape, w_i8.shape[1]
    dev = x_i8.device
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    bf16 = int(out_dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib, fns = _entry()
    if how == "tma":
        t = tile or tiling(M, K, N)
        ws = counts = None
        if t.split > 1:
            ws = torch.empty((t.split, M, N), dtype=torch.int32, device=dev)
            counts = torch.zeros(-(-M // t.bm) * -(-N // CHANNELS),
                                 dtype=torch.int32, device=dev)
        err = fns["tma"](x_i8.data_ptr(), w_i8.data_ptr(),
                         exp_i32.data_ptr(), out.data_ptr(),
                         None if ws is None else ws.data_ptr(),
                         None if counts is None else counts.data_ptr(),
                         M, N, K, bf16, t.bm, t.split, t.kt_per, stream)
    elif how == "mma":
        err = fns["mma"](x_i8.data_ptr(), w_i8.data_ptr(),
                         exp_i32.data_ptr(), out.data_ptr(), M, N, K, bf16,
                         stream)
    else:
        raise ValueError(f"route must be one of {ROUTES}, not {how!r}")
    build.check(lib, "qmatmul", err)
    qmatmul_kernel.launches += 1
    qmatmul_kernel.route_launches[how] += 1
    return out


def qmatmul_kernel(x_i8: torch.Tensor, w_i8: torch.Tensor,
                   exp_i32: torch.Tensor, *,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The CUDA kernel: the contract of :func:`qmatmul_plain`, bit
    identical to it, on contiguous CUDA tensors of one device: x (M, K)
    and w (K, N) int8, exp (N,) int32; any M, K, N.  The route is
    :func:`route`'s."""
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
    how = route(x_i8.shape[1], w_i8.shape[1], x_i8.data_ptr(),
                w_i8.data_ptr())
    return launch(x_i8, w_i8, exp_i32, out_dtype, how)


qmatmul_kernel.launches = 0
qmatmul_kernel.route_launches = dict.fromkeys(ROUTES, 0)
