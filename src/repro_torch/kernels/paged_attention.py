"""Fused block-paged decode attention: softmax(q K^T) V straight from the
KV block pool.

Counterpart of ``repro/kernels/paged_attention.py``.  The pool is
``(NB, bs, Hkv, D)``, addressed by a per-slot block table; one query token
per slot attends to the first ``cache_len`` positions of its logical row.

Source note.  :func:`paged_attention_kernel` launches
``csrc/paged_attention.cu`` and replaces the Pallas TPU kernel
``repro/kernels/paged_attention.py::paged_attention_kernel``.  It is bound
by bytes: a decode token does 4*D flops per KV element read.  One thread
block per (slot, KV head) shares each K/V tile between the group's G query
heads, walks only the ``ceil(cache_len / bs)`` blocks the slot needs
(loading its own table entries), and keeps the online-softmax state in f32.

The softmax is base-2 with an integer running max, and its rescale factor
is :func:`pow2_int`, an exact power of two: ``carry * corr`` never rounds,
in the kernel or in :func:`paged_attention_plain`, the block-sequential
loop that is its plain PyTorch version (and the port's
``paged_decode_attention_ref``).  Only the order of the dot products and
sums separates the two.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build

__all__ = ["NEG_INF", "LOG2E", "pow2_int", "paged_attention_plain",
           "paged_attention_kernel"]

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def pow2_int(delta: torch.Tensor) -> torch.Tensor:
    """Exact ``2.0 ** delta`` for integer-valued f32 ``delta <= 0``.

    Built from the f32 exponent bits: the exact power of two for ``delta``
    in [-126, 0] and exactly ``0.0`` below (the total-rescale wipe; it also
    absorbs ``NEG_INF - finite`` without int32 overflow)."""
    k = torch.clamp(delta, min=-150.0).to(torch.int32)   # truncates, as astype
    bits = (torch.clamp(k, -126, 0) + 127) << 23
    val = bits.view(torch.float32)
    return torch.where(k < -126, torch.zeros_like(val), val)


def paged_attention_plain(q, k_pool, v_pool, table, cache_len, *,
                          window: int = 0):
    """Block-sequential online-softmax decode attention over the pool.

    q: (B, 1, Hq, D); pools: (NB, bs, Hkv, D); table: (B, nb) block ids
    (the sentinel NB is clamped to NB - 1; the block it reads is fully
    masked); cache_len: scalar or (B,) valid lengths.  One step per logical
    block, carrying (running max, denominator, accumulator) in f32: scores
    ``q.k * log2(e)/sqrt(D)``, masked to NEG_INF (whose exp2 underflows to
    exactly 0.0), ``m_new = max(m, ceil(rowmax))``, ``p = exp2(s - m_new)``,
    rescale ``pow2_int(m - m_new)``, and ``p`` rounded to the pool's type
    before the PV product.  Returns (B, 1, Hq, D) in q.dtype."""
    B, _, Hq, D = q.shape
    NB, bs, Hkv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    nb = table.shape[1]
    G = Hq // Hkv
    dev = q.device
    scale = LOG2E / math.sqrt(D)
    qg = q.reshape(B, Hkv, G, D).float()
    clen = torch.as_tensor(cache_len, dtype=torch.int32,
                           device=dev).reshape(-1).expand(B)
    tbl = torch.clamp(table.to(torch.int64), max=NB - 1)
    offs = torch.arange(bs, device=dev)
    m = torch.full((B, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=dev)
    for j in range(nb):
        kb = k_pool.index_select(0, tbl[:, j])              # (B, bs, Hkv, D)
        vb = v_pool.index_select(0, tbl[:, j])
        s = torch.einsum("bhgd,bkhd->bhgk", qg, kb.float()) * scale
        pos = j * bs + offs
        valid = pos[None, :] < clen[:, None]
        if window:
            valid &= pos[None, :] >= clen[:, None] - window
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, torch.ceil(s.amax(dim=-1)))
        p = torch.exp2(s - m_new[..., None])
        corr = pow2_int(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgk,bkhd->bhgd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-20)
    return out.reshape(B, 1, Hq, D).to(q.dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448                       # bytes one block may use on Hopper


@functools.cache
def _entry():
    lib = build.load("paged_attention")
    fn = lib.paged_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def paged_attention_kernel(q, k_pool, v_pool, table, cache_len, *,
                           window: int = 0):
    """The CUDA kernel: the contract of :func:`paged_attention_plain` with
    ``table`` (B, nb) int32 already clamped below NB and ``cache_len`` a
    (B,) int32 vector with entries <= nb * bs (the ``ops.paged_attention``
    wrapper prepares both).  Inputs are contiguous CUDA tensors of one
    dtype, float32 or bfloat16."""
    tensors = (q, k_pool, v_pool, table, cache_len)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_attention_kernel takes CUDA tensors on one "
                         "device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_kernel needs contiguous inputs")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"unsupported dtypes {q.dtype}, {k_pool.dtype}, "
                         f"{v_pool.dtype}")
    if table.dtype != torch.int32 or cache_len.dtype != torch.int32:
        raise ValueError("table and cache_len must be int32")
    B, one, Hq, D = q.shape
    NB, bs, Hkv, Dk = k_pool.shape
    nb = table.shape[1]
    if one != 1 or Dk != D or v_pool.shape != k_pool.shape \
            or Hq % Hkv or table.shape[0] != B or cache_len.shape != (B,):
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, pool "
                         f"{tuple(k_pool.shape)}, table {tuple(table.shape)}, "
                         f"cache_len {tuple(cache_len.shape)}")
    vec = 16 // q.element_size()
    if D % vec or any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError(f"head_dim {D} must be a multiple of {vec} and the "
                         "tensors 16-byte aligned")
    G = Hq // Hkv
    smem = 4 * (2 * G * D + bs * (2 * D + 1) + G * bs + 3 * G)
    if smem > _MAX_SMEM:
        raise ValueError(f"block size {bs} x head_dim {D} needs {smem} bytes "
                         "of shared memory")
    out = torch.empty_like(q)
    lib, fn = _entry()
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             table.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
             B, Hq, Hkv, D, bs, nb, int(window), LOG2E / math.sqrt(D),
             _DTYPE_CODE[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, "paged_attention", err)
    paged_attention_kernel.launches += 1
    return out


paged_attention_kernel.launches = 0
