"""Fused block-paged decode attention: softmax(q K^T) V straight from the
KV block pool.

Counterpart of ``repro/kernels/paged_attention.py``.  The pool is
``(NB, bs, Hkv, D)``, addressed by a per-slot block table; one query token
per slot attends to the first ``cache_len`` positions of its logical row.

Source note.  :func:`paged_attention_kernel` launches
``csrc/paged_attention.cu`` and replaces the Pallas TPU kernel
``repro/kernels/paged_attention.py::paged_attention_kernel``.  It is bound
by bytes: a decode token does 4*D flops per KV element read.  The TPU
kernel walks a slot's blocks in grid order; on the card one block per
(slot, KV head) would be 16 blocks at the serving shape, each walking its
blocks in turn, so the kernel splits the KV walk (flash-decoding): the
grid is (B * Hkv, S), split s walks the run of ``c`` logical blocks
:func:`splits` gives it (cut at ``ceil(cache_len / bs)`` and at the
window), its next blocks in flight by ``cp.async`` while one computes,
the group's G query heads sharing every K/V tile.  bf16 pools (the
serving path's) compute on the tensor cores, ``mma.sync`` with the G
heads as the rows of one tile, two warps each taking every other block of
the split; f32 pools and other shapes on the CUDA cores, a warp a head.
Each split writes its ``(m, l, acc)`` to an f32 workspace, and a second
kernel, launched as a programmatic dependent of the first, combines them
with exact power-of-two weights (the source's note says more).

The softmax is base-2 with an integer running max, and its rescale factor
is :func:`pow2_int`, an exact power of two: ``carry * corr`` never rounds,
in the kernel, in :func:`paged_attention_plain` (the block-sequential loop
that is its plain PyTorch version, and the port's
``paged_decode_attention_ref``) or in :func:`paged_attention_split_plain`
(the kernel's split-and-combine rule in plain PyTorch, for the tests).
Only the order of the sums, and where ``s - m`` rounds, separate them.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build

__all__ = ["NEG_INF", "LOG2E", "SMS", "MAX_SPLITS", "pow2_int", "splits",
           "split_shape", "workspace_bytes", "paged_attention_plain",
           "paged_attention_split_plain", "paged_attention_kernel"]

NEG_INF = -1e30
LOG2E = 1.4426950408889634
SMS = 132                # the H100's streaming multiprocessors
BLOCKS_PER_SM = 2        # thread blocks the split rule aims at per SM
MAX_SPLITS = 32          # csrc/paged_attention.cu's kMaxSplits: a lane each


def pow2_int(delta: torch.Tensor) -> torch.Tensor:
    """Exact ``2.0 ** delta`` for integer-valued f32 ``delta <= 0``.

    Built from the f32 exponent bits: the exact power of two for ``delta``
    in [-126, 0] and exactly ``0.0`` below (the total-rescale wipe; it also
    absorbs ``NEG_INF - finite`` without int32 overflow)."""
    k = torch.clamp(delta, min=-150.0).to(torch.int32)   # truncates, as astype
    bits = (torch.clamp(k, -126, 0) + 127) << 23
    val = bits.view(torch.float32)
    return torch.where(k < -126, torch.zeros_like(val), val)


def split_shape(nb: int, n_splits: int) -> tuple[int, int]:
    """(S, c) for at most ``n_splits`` (and ``MAX_SPLITS``) splits of a
    walk over ``nb`` logical blocks: c = ceil(nb / n_splits) blocks a split
    and S = ceil(nb / c) splits, so no split starts past the table."""
    c = -(-nb // max(1, min(n_splits, nb, MAX_SPLITS)))
    return -(-nb // c), c


def splits(B: int, Hkv: int, nb: int) -> tuple[int, int]:
    """The kernel's split rule, from shapes only (the lengths stay on the
    card): enough splits that the (B * Hkv, S) grid holds about
    ``BLOCKS_PER_SM`` blocks per SM, at most one a logical block.  At the
    serving shape (8 slots, 2 KV heads, 32 blocks) 16 splits of 2 blocks;
    a grid that fills the card alone keeps S = 1."""
    want = -(-BLOCKS_PER_SM * SMS // max(1, B * Hkv))
    return split_shape(nb, want)


def workspace_bytes(B: int, Hq: int, D: int, S: int) -> int:
    """Bytes of the f32 partials (acc, m, l a query head and split) the
    kernel writes at S splits; none at S = 1."""
    return 0 if S == 1 else 4 * B * Hq * S * (D + 2)


def _setup(q, k_pool, table, cache_len):
    B, _, Hq, D = q.shape
    NB, bs, Hkv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    dev = q.device
    clen = torch.as_tensor(cache_len, dtype=torch.int32,
                           device=dev).reshape(-1).expand(B)
    tbl = torch.clamp(table.to(torch.int64), max=NB - 1)
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    return qg, clen, tbl, bs, LOG2E / math.sqrt(D)


def _block_step(state, qg, k_pool, v_pool, blk, first, clen, window, scale):
    """One logical block of the online softmax: blocks ``blk`` (B,) of the
    pools at positions ``first + [0, bs)``; returns the new (m, l, acc)."""
    m, l, acc = state
    bs = k_pool.shape[1]
    kb = k_pool.index_select(0, blk)                    # (B, bs, Hkv, D)
    vb = v_pool.index_select(0, blk)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, kb.float()) * scale
    pos = first + torch.arange(bs, device=qg.device)
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
    return m_new, l, acc


def _empty_state(qg):
    B, Hkv, G, D = qg.shape
    return (torch.full((B, Hkv, G), NEG_INF, dtype=torch.float32,
                       device=qg.device),
            torch.zeros((B, Hkv, G), dtype=torch.float32, device=qg.device),
            torch.zeros((B, Hkv, G, D), dtype=torch.float32,
                        device=qg.device))


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
    qg, clen, tbl, bs, scale = _setup(q, k_pool, table, cache_len)
    state = _empty_state(qg)
    for j in range(table.shape[1]):
        state = _block_step(state, qg, k_pool, v_pool, tbl[:, j], j * bs,
                            clen, window, scale)
    _, l, acc = state
    out = acc / torch.clamp(l[..., None], min=1e-20)
    return out.reshape(q.shape).to(q.dtype)


def paged_attention_split_plain(q, k_pool, v_pool, table, cache_len, *,
                                window: int = 0, n_splits: int = 1):
    """The kernel's split-and-combine rule in plain PyTorch (the tests hold
    it against :func:`paged_attention_plain` and the reference).

    The walk over the table's nb blocks is cut into :func:`split_shape`'s
    (S, c) runs.  Each split keeps its own (m, l, acc), starting at
    (NEG_INF, 0, 0), and steps only over the blocks the kernel enters:
    ``j * bs < cache_len`` and, with a window, ``(j + 1) * bs > cache_len
    - window`` (a split that enters none keeps (NEG_INF, 0, 0)).  Then
    ``m = max_s m_s``, ``w_s = pow2_int(m_s - m)``, ``l = sum_s w_s l_s``,
    ``acc = sum_s w_s acc_s`` and ``out = acc / max(l, 1e-20)``."""
    qg, clen, tbl, bs, scale = _setup(q, k_pool, table, cache_len)
    nb = table.shape[1]
    S, c = split_shape(nb, n_splits)
    parts = []
    for s in range(S):
        state = _empty_state(qg)
        for j in range(s * c, min((s + 1) * c, nb)):
            run = j * bs < clen
            if window:
                run &= (j + 1) * bs > clen - window
            new = _block_step(state, qg, k_pool, v_pool, tbl[:, j], j * bs,
                              clen, window, scale)
            state = tuple(torch.where(run.reshape((-1,) + (1,) * (x.ndim - 1)),
                                      x, y) for x, y in zip(new, state))
        parts.append(state)
    m_s, l_s, acc_s = (torch.stack(x) for x in zip(*parts))
    w = pow2_int(m_s - m_s.amax(dim=0))
    l = (w * l_s).sum(dim=0)
    acc = (w[..., None] * acc_s).sum(dim=0)
    out = acc / torch.clamp(l[..., None], min=1e-20)
    return out.reshape(q.shape).to(q.dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448                       # bytes one block may use on Hopper
_STAGES = 3                      # the CUDA-core kernel's ring (kStages): the
                                 # check below is its shared memory; the
                                 # tensor-core kernel's fits where it runs


@functools.cache
def _entry():
    lib = build.load("paged_attention")
    fn = lib.paged_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def paged_attention_kernel(q, k_pool, v_pool, table, cache_len, *,
                           window: int = 0, n_splits: int | None = None):
    """The CUDA kernel: the contract of :func:`paged_attention_plain` with
    ``table`` (B, nb) int32 already clamped below NB and ``cache_len`` a
    (B,) int32 vector with entries <= nb * bs (the ``ops.paged_attention``
    wrapper prepares both).  Inputs are contiguous CUDA tensors of one
    dtype, float32 or bfloat16.  The walk is split by :func:`splits`, or
    into :func:`split_shape`'s splits for at most ``n_splits`` (the tests
    force S = 1 with it).  One launch, counted in ``launches``; for S > 1
    the wrapper allocates the workspace, and the combine kernel's launch is
    counted in ``combine_launches``."""
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
    smem = (_STAGES * 2 * bs * (D + vec) * q.element_size()
            + 4 * (2 * G * D + G * bs + 2 * G))
    if smem > _MAX_SMEM:
        raise ValueError(f"block size {bs} x head_dim {D} needs {smem} bytes "
                         "of shared memory")
    S, c = splits(B, Hkv, nb) if n_splits is None else split_shape(nb,
                                                                   n_splits)
    out = torch.empty_like(q)
    ws = None
    if S > 1:
        ws = torch.empty(workspace_bytes(B, Hq, D, S) // 4,
                         dtype=torch.float32, device=q.device)
    lib, fn = _entry()
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             table.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(),
             B, Hq, Hkv, D, bs, nb, int(window), S, c, LOG2E / math.sqrt(D),
             _DTYPE_CODE[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, "paged_attention", err)
    paged_attention_kernel.launches += 1
    paged_attention_kernel.combine_launches += S > 1
    return out


paged_attention_kernel.launches = 0
paged_attention_kernel.combine_launches = 0
