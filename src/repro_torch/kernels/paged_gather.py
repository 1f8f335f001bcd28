"""Block-table KV gather: assemble logical cache rows from a block pool.

Counterpart of ``repro/kernels/paged_gather.py``.  The block-paged serving
cache stores K/V as a pool of fixed-size blocks ``(NB, bs, H, D)``; a
per-slot block table ``(B, nb)`` maps logical block j of slot b to its
physical block.  Attention over the logical rows needs them contiguous,
which is a pure gather.

Source note.  :func:`paged_gather_kernel` (one leaf) and
:func:`paged_gather_pair_kernel` (a layer's K and V through one table, in
one launch) launch ``csrc/paged_gather.cu`` and replace the Pallas TPU
kernel ``repro/kernels/paged_gather.py::paged_gather_kernel``.  They are
bound by bytes: each gathered block is read once and written once, with no
arithmetic.  The kernel reads the table as it comes (int32 or int64) and
maps the sentinel NB to NB - 1 itself, so no cast or clamp kernel runs
beside it.  Where every pointer is on a 16-byte boundary one thread a
block moves a whole block (up to 16 KiB) with one bulk copy into shared
memory and one out (route ``"bulk"``); elsewhere 128 threads copy it with
vector loads, all made before any store (route ``"vector"``).
:func:`paged_gather_plain` is the same function in plain PyTorch; the CPU
path and the kernel's on-card check use it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["paged_gather_plain", "paged_gather_kernel",
           "paged_gather_pair_kernel", "ROUTES"]


def paged_gather_plain(leaf: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """leaf: (NB, bs, H, D); table: (B, nb) integer block ids in [0, NB).
    Returns (B, nb, bs, H, D)."""
    B, nb = table.shape
    out = leaf.index_select(0, table.reshape(-1).to(torch.int64))
    return out.reshape(B, nb, *leaf.shape[1:])


ROUTES = ("bulk", "vector")


@functools.cache
def _entry(name: str):
    lib = build.load("paged_gather")
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * (3 if name == "paged_gather" else 5) \
        + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(leaves, table: torch.Tensor, what: str) -> None:
    leaf = leaves[0]
    if not leaf.is_cuda or any(t.device != leaf.device
                               for t in (*leaves, table)):
        raise ValueError(f"{what} takes CUDA tensors on one device")
    if table.ndim != 2 or leaf.ndim < 2 or any(
            t.shape != leaf.shape or t.dtype != leaf.dtype for t in leaves):
        raise ValueError(f"bad shapes: leaves "
                         f"{[tuple(t.shape) for t in leaves]}, table "
                         f"{tuple(table.shape)}")
    if table.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{what} takes an int32 or int64 table, not "
                         f"{table.dtype}")
    if not all(t.is_contiguous() for t in (*leaves, table)):
        raise ValueError(f"{what} needs contiguous pools and table")


def _launch(name, leaves, table, route):
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, not {route!r}")
    leaf = leaves[0]
    B, nb = table.shape
    outs = [torch.empty((B, nb, *leaf.shape[1:]), dtype=leaf.dtype,
                        device=leaf.device) for _ in leaves]
    block_bytes = leaf[0].numel() * leaf.element_size()
    lib, fn = _entry(name)
    err = fn(*[t.data_ptr() for t in leaves], table.data_ptr(),
             *[o.data_ptr() for o in outs], B * nb, leaf.shape[0],
             block_bytes, int(table.dtype == torch.int64),
             ROUTES.index(route),
             torch.cuda.current_stream(leaf.device).cuda_stream)
    build.check(lib, name, err)
    return outs


def paged_gather_kernel(leaf: torch.Tensor, table: torch.Tensor, *,
                        route: str = "bulk") -> torch.Tensor:
    """The CUDA gather: the contract of :func:`paged_gather_plain` on the
    clamped table, bit-identical to it.  ``leaf`` a contiguous CUDA tensor,
    ``table`` (B, nb) contiguous int32 or int64 on its device; entries >= NB
    (the unallocated sentinel) read block NB - 1.  ``route`` ``"bulk"``
    takes the bulk copy where every pointer is on a 16-byte boundary (the
    vector route elsewhere); ``"vector"`` forces the vector route."""
    _check((leaf,), table, "paged_gather_kernel")
    out, = _launch("paged_gather", (leaf,), table, route)
    paged_gather_kernel.launches += 1
    return out


def paged_gather_pair_kernel(k_leaf: torch.Tensor, v_leaf: torch.Tensor,
                             table: torch.Tensor, *, route: str = "bulk"):
    """A layer's K and V gathered through one table in one launch: equal
    to ``(paged_gather_kernel(k_leaf, table), paged_gather_kernel(v_leaf,
    table))`` bit for bit.  Both leaves of one shape and dtype."""
    _check((k_leaf, v_leaf), table, "paged_gather_pair_kernel")
    k, v = _launch("paged_gather_pair", (k_leaf, v_leaf), table, route)
    paged_gather_pair_kernel.launches += 1
    return k, v


paged_gather_kernel.launches = 0
paged_gather_pair_kernel.launches = 0
