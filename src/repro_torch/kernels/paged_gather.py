"""Block-table KV gather: assemble logical cache rows from a block pool.

Counterpart of ``repro/kernels/paged_gather.py``.  The block-paged serving
cache stores K/V as a pool of fixed-size blocks ``(NB, bs, H, D)``; a
per-slot block table ``(B, nb)`` maps logical block j of slot b to its
physical block.  Attention over the logical rows needs them contiguous,
which is a pure gather.

Source note.  :func:`paged_gather_kernel` launches ``csrc/paged_gather.cu``
and replaces the Pallas TPU kernel
``repro/kernels/paged_gather.py::paged_gather_kernel``.  It is bound by
bytes: each gathered block is read once and written once, with no
arithmetic.  One thread block per ``(b, j)`` reads its own table entry and
copies that block with 16-byte vector loads and stores.
:func:`paged_gather_plain` is the same function in plain PyTorch; the CPU
path and the kernel's on-card check use it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["paged_gather_plain", "paged_gather_kernel"]


def paged_gather_plain(leaf: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """leaf: (NB, bs, H, D); table: (B, nb) integer block ids in [0, NB).
    Returns (B, nb, bs, H, D)."""
    B, nb = table.shape
    out = leaf.index_select(0, table.reshape(-1).to(torch.int64))
    return out.reshape(B, nb, *leaf.shape[1:])


@functools.cache
def _entry():
    lib = build.load("paged_gather")
    fn = lib.paged_gather
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def paged_gather_kernel(leaf: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The CUDA gather: the same contract as :func:`paged_gather_plain`,
    bit-identical to it.  ``leaf`` must be a contiguous CUDA tensor; table
    entries must lie in [0, NB) (the ``ops.paged_gather`` wrapper clamps
    the unallocated sentinel NB to NB - 1)."""
    if not leaf.is_cuda or table.device != leaf.device:
        raise ValueError("paged_gather_kernel takes CUDA tensors on one "
                         "device")
    if table.ndim != 2 or leaf.ndim < 2:
        raise ValueError(f"bad shapes: leaf {tuple(leaf.shape)}, "
                         f"table {tuple(table.shape)}")
    if not leaf.is_contiguous():
        raise ValueError("paged_gather_kernel needs a contiguous pool")
    B, nb = table.shape
    tbl = table.to(torch.int32).contiguous()
    out = torch.empty((B, nb, *leaf.shape[1:]), dtype=leaf.dtype,
                      device=leaf.device)
    block_bytes = leaf[0].numel() * leaf.element_size()
    lib, fn = _entry()
    err = fn(leaf.data_ptr(), tbl.data_ptr(), out.data_ptr(), B * nb,
             block_bytes, torch.cuda.current_stream(leaf.device).cuda_stream)
    build.check(lib, "paged_gather", err)
    paged_gather_kernel.launches += 1
    return out


paged_gather_kernel.launches = 0
