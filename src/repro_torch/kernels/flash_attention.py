"""Flash attention: online-softmax attention with causal and local
windows, GQA, and a ``kv_len`` / ``offset`` alignment.

Counterpart of ``repro/kernels/flash_attention.py``.  q (B, Sq, Hq, D)
attends to k, v (B, Skv, Hkv, D); query head h reads KV head
``h // (Hq // Hkv)``.  Query row i sits at position ``i + offset`` and sees
key j when ``j < kv_len``, ``j <= i + offset`` (causal) and
``j > i + offset - window`` (``window > 0``).

Source note.  :func:`flash_attention_kernel` launches
``csrc/flash_attention.cu`` and replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention_kernel`` (with its
padded wrapper).  At the main path's shapes it is bound by operations:
4 * D flops per visible (query, key) pair.  The C entry point picks one of
two routes by dtype:

* bfloat16 -- the tensor cores.  One block per (128 query rows, query
  head, batch row), two warpgroups of 64 rows sharing K/V.  Q is loaded
  once by TMA; K and V tiles of ``KEY_TILE`` = 64 keys come by TMA
  through a two-stage ring on mbarriers, so the next tile's copy overlaps
  the current one's products.  S = Q K^T and O += P V are ``wgmma``
  products (Q and K from shared memory; P from registers, rounded to bf16
  straight into the A fragments), the online softmax runs in registers
  with ``ex2.approx`` on scores pre-multiplied by log2(e), the mask only
  on tiles that straddle a boundary, and the output leaves by a TMA
  store.  At D = 256 the 64 x 256 f32 accumulator takes 128 registers a
  thread; Q stays in shared memory and nothing spills.
* float32 -- the CUDA cores, the first version kept for the checks that
  hold f32 results tightly (TF32 would break them): one block per (64
  query rows, query head, batch row), K/V tiles of 32 keys staged in
  shared memory as f32, the online softmax per tile.

Both routes walk only the tiles some row of the block needs (the causal
frontier and the window bound the walk) and keep the TPU kernel's
arithmetic: f32 scores times ``1/sqrt(D)``, masked scores exactly
``NEG_INF = -1e30``, the running max starting at ``NEG_INF``, ``p``
rounded to v's dtype before the PV product, and ``acc / max(l, 1e-20)``.
A masked key met before a row's first visible key adds ``exp(0) = 1`` to
``l``; the first visible key rescales it by exactly 0.  A row that sees no
key keeps the mean of v over the keys it walked: every key of the kv
length padded to ``bk`` (the padding reads as zeros), the rule of
``repro.nn.layers.chunked_attention``.  Rows with a visible key do not
depend on ``bk``.

:func:`flash_attention_plain` is the same function in plain PyTorch, the
blocked online softmax of ``chunked_attention``; the CPU path and the
kernel's on-card check use it.  In bf16 the two round p against the
running max of their own key tiles, so :func:`bf16_disagreement` holds
them to each other with the plain version at ``bk=KEY_TILE``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from . import build

__all__ = ["NEG_INF", "KEY_TILE", "flash_attention_plain",
           "flash_attention_kernel", "bf16_disagreement"]
# ``flash_attention``, the reference's module-level name, is the dispatching op
# of ``ops.py``, which binds it into this module.

NEG_INF = -1e30
KEY_TILE = 64      # keys per online-softmax step of the bf16 kernel (kKT),
                   # at every head dim; the f32 kernel steps over 32


def _resolve(Sq: int, Skv: int, kv_len, offset):
    kv_len = Skv if kv_len is None else int(kv_len)
    offset = kv_len - Sq if offset is None else int(offset)
    return kv_len, offset


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          kv_len=None, offset=None, bk: int = 256):
    """Blocked online-softmax attention over tiles of ``bk`` keys.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); ``kv_len`` (default Skv)
    real keys; ``offset`` (default ``kv_len - Sq``) the position of query
    row 0.  GQA is a grouped contraction; the repeated K/V never
    materializes.  One step per kv tile for all query rows at once.
    Returns (B, Sq, Hq, D) in q.dtype."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kv_len, offset = _resolve(Sq, Skv, kv_len, offset)
    dev = q.device
    n_kv = -(-Skv // bk)
    pad = n_kv * bk - Skv
    kp = F.pad(k, (0, 0, 0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad))
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    q_pos = torch.arange(Sq, device=dev) + offset
    offs = torch.arange(bk, device=dev)
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32, device=dev)
    for ki in range(n_kv):
        kb = kp[:, ki * bk:(ki + 1) * bk]
        vb = vp[:, ki * bk:(ki + 1) * bk]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb.float()) * scale
        kv_pos = ki * bk + offs
        mask = (kv_pos < kv_len)[None, :]
        if causal:
            mask = mask & (q_pos[:, None] >= kv_pos[None, :])
        if window:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]         # (B,Hkv,G,Sq,D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)


@functools.cache
def _entry():
    lib = build.load("flash_attention")
    fn = lib.flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tile = lib.flash_attention_key_tile
    tile.argtypes = []
    tile.restype = ctypes.c_int
    built = tile()
    if built != KEY_TILE:
        raise RuntimeError(f"flash_attention.cu steps over {built} keys in "
                           f"bf16, KEY_TILE says {KEY_TILE}")
    return lib, fn


def flash_attention_kernel(q, k, v, *, causal: bool = True, window: int = 0,
                           kv_len=None, offset=None, bk: int = 256):
    """The CUDA kernel: the contract of :func:`flash_attention_plain` on
    contiguous CUDA tensors of one dtype, float32 (CUDA cores) or bfloat16
    (tensor cores), with head dim D in ``HEAD_DIMS``.  ``bk`` only pads the
    kv length a row that sees no key walks; in bf16 the kernel steps over
    ``KEY_TILE`` keys at a time (32 in f32)."""
    tensors = (q, k, v)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("flash_attention_kernel takes CUDA tensors on one "
                         "device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention_kernel needs contiguous inputs")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"unsupported dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    B, Sq, Hq, D = q.shape
    Bk, Skv, Hkv, Dk = k.shape
    if Bk != B or Dk != D or v.shape != k.shape or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} is not one of {HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash_attention_kernel needs 16-byte aligned "
                         "tensors")
    kv_len, offset = _resolve(Sq, Skv, kv_len, offset)
    if not 0 <= kv_len <= Skv or bk < 1 or window < 0:
        raise ValueError(f"bad kv_len {kv_len}, tile {bk} or window "
                         f"{window}")
    out = torch.empty_like(q)
    lib, fn = _entry()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, Sq, Skv, Hq, Hkv, D, kv_len, offset, int(causal),
             int(window), -(-Skv // bk) * bk,
             1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, "flash_attention", err)
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0


# bf16 check of the kernel against flash_attention_plain(..., bk=KEY_TILE):
# each element within BF16_ULPS bf16 ulps of |want| plus 2^-8 of its row's
# largest |want| (a row: one query row and head, over D), and at most
# BF16_SHARE of the elements different at all.  Another order of f32 sums
# moves a p or an output across a rounding boundary now and then, and a
# flipped p of a row with few keys moves an element that cancels to near 0
# by more than its own ulps; a fault in the bf16 arithmetic (p left
# unrounded, another type on load or store) moves most elements.
BF16_ULPS = 2
BF16_SHARE = 0.01


def bf16_disagreement(got, want):
    """(largest |got - want| over its elementwise limit, share of elements
    that differ) for bf16 ``got`` against ``want``, both (..., D); within
    the limits the ratio is at most 1 and the share at most
    ``BF16_SHARE``."""
    g, w = got.float(), want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 8)
    limit = BF16_ULPS * torch.where(w == 0, 0.0, ulp) \
        + 2 ** -8 * w.abs().amax(dim=-1, keepdim=True)
    off = g != w
    ratio = torch.where(off, (g - w).abs() / limit, 0.0).max().item()
    return ratio, off.float().mean().item()
