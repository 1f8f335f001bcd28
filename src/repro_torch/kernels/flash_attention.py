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

The gradient.  Given ``lse=True`` both routes also write each row's
log-sum-exp (B, Hq, Sq) f32, which :func:`flash_attention_bwd_kernel`
reads: ``csrc/flash_attention_bwd.cu``, replacing no TPU kernel (the
reference differentiates ``chunked_attention`` by XLA's autodiff): delta
= rowsum(dO * O), a dQ kernel and a dK/dV kernel, each output written
once, no atomics, sums in a fixed order, so a run is deterministic; head
dims ``BWD_HEAD_DIMS``, all of the forward's.  bf16 runs on the tensor
cores (``wgmma``; a producer warp's TMA ring of 3 stages, 2 at D = 256,
feeding one or two consumer warpgroups; at D = 256 the dK/dV kernel's two
split by output, one owning dV and the other dK) in two launches: dQ a block per 64 query rows (128 at D =
128), also writing its rows' delta; dK/dV a block per 64-key tile (128
at D = 128), KV head and batch row, the G query heads' walks over the
query tiles that see its keys split evenly over a thread-block cluster
of :func:`bwd_cluster` blocks (a rule of the shape and the card's SM
count), their dK and dV summed in f32 in rank order.  f32 runs on the
CUDA cores in three launches (delta its own kernel; the dK/dV block
walks the G heads itself).  :class:`FlashAttention` is the ``torch.autograd.
Function`` pairing the two; :func:`flash_attention_bwd_plain` is the
backward kernels' arithmetic in plain PyTorch (the CPU tests' check of the
formulas), and autograd through :func:`flash_attention_plain` the check of
both.  Rows that see no key (``Model.loss`` never makes them) are outside
the backward's contract: it gives them zero gradients, where the forward
gave them the mean of v.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from . import build

__all__ = ["NEG_INF", "KEY_TILE", "BWD_HEAD_DIMS", "flash_attention_plain",
           "flash_attention_kernel", "flash_attention_bwd_plain",
           "bwd_walks", "bwd_cluster",
           "flash_attention_bwd_kernel", "FlashAttention",
           "bf16_disagreement", "bf16_grad_disagreement"]
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
                          kv_len=None, offset=None, bk: int = 256,
                          return_lse: bool = False):
    """Blocked online-softmax attention over tiles of ``bk`` keys.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); ``kv_len`` (default Skv)
    real keys; ``offset`` (default ``kv_len - Sq``) the position of query
    row 0.  GQA is a grouped contraction; the repeated K/V never
    materializes.  One step per kv tile for all query rows at once.
    Returns (B, Sq, Hq, D) in q.dtype, and with ``return_lse`` also each
    row's m + ln l, (B, Hq, Sq) f32."""
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
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).reshape(B, Hq, Sq)
    return out


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
BWD_HEAD_DIMS = HEAD_DIMS           # the backward's
BWD_MAX_CLUSTER = 8                 # the portable thread-block cluster size
BWD_SLACK = 1.15                    # bwd_cluster's tolerance over the share


def bwd_walks(Sq, Skv, D, *, causal, window, kv_len, offset):
    """The bf16 dK/dV kernel's walk over each of its key tiles (64 keys, 128
    at D = 128; at D = 256 the block's two warpgroups share one tile of 64,
    split by output): the number of 64-row query tiles that see the tile,
    one query head's worth (``Mask::rows`` of ``flash_attention_bwd.cu``)."""
    rows = 128 if D == 128 else 64
    walks = []
    for k0 in range(0, Skv, rows):
        k1 = min(k0 + rows, kv_len)
        lo = max(k0 - offset, 0) if causal else 0
        hi = min(Sq, k1 - 1 + window - offset) if window else Sq
        walks.append(-(-hi // 64) - lo // 64 if k0 < k1 and hi > lo else 0)
    return walks


@functools.lru_cache(maxsize=256)
def bwd_cluster(B, Sq, Skv, Hq, Hkv, D, *, causal, window, kv_len, offset,
                sms):
    """Blocks of one thread-block cluster of the bf16 dK/dV kernel, 1 to
    min(G, 8): the G query heads' walks over a (key tile, KV head, batch
    row) -- G times :func:`bwd_walks` steps -- are split evenly over the
    cluster's blocks, which then sum their dK and dV in rank order.  The
    smallest size whose longest block walk is within ``BWD_SLACK`` of the
    balanced share (every block slot of the ``sms`` SMs busy to the end;
    two blocks an SM, one at D >= 128): a longer walk leaves slots idle at
    the end, and every further block pays a start-up and its share of the
    cluster's sum."""
    G = Hq // Hkv
    walks = bwd_walks(Sq, Skv, D, causal=causal, window=window,
                      kv_len=kv_len, offset=offset)
    share = G * sum(walks) * Hkv * B / (sms * (1 if D >= 128 else 2))
    top = min(G, BWD_MAX_CLUSTER)
    for c in range(1, top):
        if -(-G * max(walks, default=0) // c) <= BWD_SLACK * share:
            return c
    return top


@functools.cache
def _entry():
    lib = build.load("flash_attention")
    fn = lib.flash_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [
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


def _check_inputs(tensors, what):
    if not all(t.is_cuda and t.device == tensors[0].device for t in tensors):
        raise ValueError(f"{what} takes CUDA tensors on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} needs contiguous inputs")
    if tensors[0].dtype not in _DTYPE_CODE or any(
            t.dtype != tensors[0].dtype for t in tensors):
        raise ValueError(f"{what}: unsupported dtypes "
                         f"{[t.dtype for t in tensors]}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what} needs 16-byte aligned tensors")


def flash_attention_kernel(q, k, v, *, causal: bool = True, window: int = 0,
                           kv_len=None, offset=None, bk: int = 256,
                           lse: bool = False):
    """The CUDA kernel: the contract of :func:`flash_attention_plain` on
    contiguous CUDA tensors of one dtype, float32 (CUDA cores) or bfloat16
    (tensor cores), with head dim D in ``HEAD_DIMS``.  ``bk`` only pads the
    kv length a row that sees no key walks; in bf16 the kernel steps over
    ``KEY_TILE`` keys at a time (32 in f32).  With ``lse`` returns (out,
    each row's m + ln l as (B, Hq, Sq) f32), the backward's input."""
    _check_inputs((q, k, v), "flash_attention_kernel")
    B, Sq, Hq, D = q.shape
    Bk, Skv, Hkv, Dk = k.shape
    if Bk != B or Dk != D or v.shape != k.shape or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} is not one of {HEAD_DIMS}")
    kv_len, offset = _resolve(Sq, Skv, kv_len, offset)
    if not 0 <= kv_len <= Skv or bk < 1 or window < 0:
        raise ValueError(f"bad kv_len {kv_len}, tile {bk} or window "
                         f"{window}")
    out = torch.empty_like(q)
    rows = torch.empty((B, Hq, Sq), dtype=torch.float32,
                       device=q.device) if lse else None
    lib, fn = _entry()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if rows is None else rows.data_ptr(),
             B, Sq, Skv, Hq, Hkv, D, kv_len, offset, int(causal),
             int(window), -(-Skv // bk) * bk,
             1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, "flash_attention", err)
    flash_attention_kernel.launches += 1
    return (out, rows) if lse else out


flash_attention_kernel.launches = 0


def flash_attention_bwd_plain(q, k, v, out, dout, lse, *, causal: bool = True,
                              window: int = 0, kv_len=None, offset=None):
    """The backward kernels' arithmetic in plain PyTorch: (dq, dk, dv) in
    the inputs' dtypes, from the forward's ``out`` and ``lse`` (B, Hq, Sq)
    and the output's gradient ``dout``.  P = exp(scale q.k - lse) where the
    row sees the key, delta = rowsum(dout * out), dS = P (dout.v - delta);
    dv = P^T dout with P rounded to v's dtype, dk = scale dS^T q and dq =
    scale dS k with dS rounded to q's dtype (the tensor-core operands), in
    f32.  Rows that see no key get zero gradients."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kv_len, offset = _resolve(Sq, Skv, kv_len, offset)
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    q_pos = torch.arange(Sq, device=dev)[:, None] + offset
    kv_pos = torch.arange(Skv, device=dev)[None, :]
    mask = kv_pos < kv_len
    if causal:
        mask = mask & (kv_pos <= q_pos)
    if window:
        mask = mask & (kv_pos > q_pos - window)
    qg = q.float().reshape(B, Sq, Hkv, G, D)
    dog = dout.float().reshape(B, Sq, Hkv, G, D)
    delta = (dout.float() * out.float()).sum(-1)             # (B, Sq, Hq)
    delta = delta.reshape(B, Sq, Hkv, G).permute(0, 2, 3, 1)[..., None]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    p = torch.where(mask, torch.exp(s - lse.reshape(B, Hkv, G, Sq, 1)), 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = (p * (dp - delta)).to(q.dtype).float()
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(v.dtype).float(), dog)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    return (dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@functools.cache
def _bwd_entry():
    lib = build.load("flash_attention_bwd")
    delta = lib.flash_attention_bwd_delta
    delta.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    delta.restype = ctypes.c_int
    grads = lib.flash_attention_bwd
    grads.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [
        ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p]
    grads.restype = ctypes.c_int
    return lib, delta, grads


def flash_attention_bwd_kernel(q, k, v, out, dout, lse, *, causal: bool = True,
                               window: int = 0, kv_len=None, offset=None):
    """The backward kernels: (dq, dk, dv) of the forward's contract on
    contiguous CUDA tensors of one dtype (f32 on the CUDA cores, bf16 on
    the tensor cores), head dim D in ``BWD_HEAD_DIMS``, ``lse`` (B, Hq, Sq)
    f32 from ``flash_attention_kernel(..., lse=True)``.  One call, one
    count, deterministic: in f32 three launches (delta, dq, dk and dv); in
    bf16 two (dq, which also writes delta, then dk and dv on clusters of
    :func:`bwd_cluster` blocks)."""
    _check_inputs((q, k, v, out, dout), "flash_attention_bwd_kernel")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, Hkv, D) or v.shape != k.shape \
            or out.shape != q.shape or dout.shape != q.shape \
            or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}")
    if D not in BWD_HEAD_DIMS:
        raise ValueError(f"head_dim {D} is not one of {BWD_HEAD_DIMS}")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be (B, Hq, Sq) contiguous f32 on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype}")
    kv_len, offset = _resolve(Sq, Skv, kv_len, offset)
    if not 0 <= kv_len <= Skv or window < 0:
        raise ValueError(f"bad kv_len {kv_len} or window {window}")
    dt = _DTYPE_CODE[q.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lib, fn_delta, fn = _bwd_entry()
    if dt == 0:                     # bf16: the dq launch writes delta
        build.check(lib, "flash_attention_bwd", fn_delta(
            out.data_ptr(), dout.data_ptr(), delta.data_ptr(), B, Sq, Hq, D,
            dt, stream))
    cluster = 1 if dt == 0 else bwd_cluster(
        B, Sq, Skv, Hq, Hkv, D, causal=bool(causal), window=window,
        kv_len=kv_len, offset=offset,
        sms=torch.cuda.get_device_properties(q.device).multi_processor_count)
    tail = (B, Sq, Skv, Hq, Hkv, D, kv_len, offset, int(causal), int(window),
            1.0 / math.sqrt(D), dt, cluster, stream)
    for which in (2, 1):            # dq, then dk and dv
        build.check(lib, "flash_attention_bwd", fn(
            which, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), *tail))
    flash_attention_bwd_kernel.launches += 1
    return dq, dk, dv


flash_attention_bwd_kernel.launches = 0


class FlashAttention(torch.autograd.Function):
    """The kernel pair under autograd: the forward kernel writing its rows'
    lse, the backward kernels reading it.  ``kw``: the forward's keywords
    (``causal``, ``window``, ``kv_len``, ``offset``, ``bk``)."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        out, lse = flash_attention_kernel(q, k, v, lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = {key: kw[key] for key in ("causal", "window", "kv_len",
                                           "offset")}
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_kernel(q, k, v, out,
                                                dout.contiguous(), lse,
                                                **ctx.kw)
        return dq, dk, dv, None


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


# The backward's checks.  f32: each of dq, dk, dv within BWD_F32_TOL of its
# largest magnitude (the same sums in another order).  bf16 (the kernels'
# operands P and dS rounded, against autograd through the bf16 plain
# version, which rounds other intermediates): the largest difference within
# BWD_BF16_MAX of the largest magnitude and the mean within BWD_BF16_MEAN of
# the mean magnitude; both are about 5e-3 / 3e-3 at the shapes of the tests,
# and a wrong mask moves them by orders of magnitude.
BWD_F32_TOL = 2e-5
BWD_BF16_MAX = 2 ** -6
BWD_BF16_MEAN = 2 ** -7


def bf16_grad_disagreement(got, want):
    """(max |got - want| / max |want|, mean |got - want| / mean |want|) of
    two gradients, in f32."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    return ((err.max() / w.abs().max()).item(),
            (err.mean() / w.abs().mean()).item())

