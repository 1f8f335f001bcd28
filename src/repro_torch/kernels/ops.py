"""Public wrappers around the kernels, and the quantization helper that
connects them to ``repro_torch.quant`` (counterpart of
``repro/kernels/ops.py``).

A wrapper given CUDA tensors launches its CUDA kernel or raises; it takes
the kernel's plain PyTorch version only for tensors on the CPU.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.core.csd import to_csd_array

from .chain_scan import (chain_scan_kernel, chain_scan_plain, tm_chain_kernel,
                         tm_chain_plain)
from .csd_matvec import (csd_matvec_kernel, csd_matvec_plain,
                         csd_qsweep_kernel, csd_qsweep_plain)
from .flash_attention import (FlashAttention, flash_attention_kernel,
                              flash_attention_plain)
from .linear_scan import LinearScan, linear_scan_kernel, linear_scan_plain
from .paged_attention import paged_attention_kernel, paged_attention_plain
from .paged_gather import (paged_gather_kernel, paged_gather_pair_kernel,
                           paged_gather_plain)
from .qmatmul import qmatmul_kernel, qmatmul_plain
from .wkv6 import Wkv6, _aligned16, wkv6_kernel, wkv6_plain

__all__ = ["qmatmul", "quantize_pot", "exp2_int", "paged_gather",
           "paged_gather_pair", "paged_attention", "csd_expand",
           "csd_expand_stack", "csd_matvec", "csd_qsweep", "flash_attention",
           "linear_scan", "chain_scan", "tm_chain", "wkv6"]


def csd_expand(w_int, depth: int | None = None) -> np.ndarray:
    """(n, m) integer matrix -> (D, n, m) int8 CSD digit planes, LSB first,
    by the whole-array CSD recoder (``repro_torch.core.csd.to_csd_array``,
    DESIGN.md 11.1).  ``depth`` pads the plane stack to a common D."""
    return to_csd_array(np.asarray(w_int, dtype=np.int64), depth=depth)


def csd_expand_stack(ws) -> np.ndarray:
    """Q same-shape integer matrices -> one (Q, D, n, m) int8 plane stack at
    the shared depth D = max over the batch: :func:`csd_qsweep`'s input
    contract (zero planes pad the shallower networks, adding nothing)."""
    per = [csd_expand(w) for w in ws]
    depth = max(p.shape[0] for p in per)
    return np.stack([np.pad(p, ((0, depth - p.shape[0]),) + ((0, 0),) * 2)
                     for p in per])


def exp2_int(e: torch.Tensor) -> torch.Tensor:
    """Exact ``2.0 ** e`` in f32 for integer ``e`` in [-126, 127], built
    from the exponent bits (the same bits on every device)."""
    bits = (torch.clamp(e.to(torch.int32), -126, 127) + 127) << 23
    return bits.view(torch.float32)


def quantize_pot(w: torch.Tensor, *, bits: int = 8, axis=0):
    """Per-channel power-of-two-scale integer quantization (paper IV-A per
    channel): exp[n] = floor(log2(qmax / max|w_n|)), the largest e with
    max|w_n| * 2^e <= 2^(bits-1)-1; returns (w_int8, exp) with
    w ~= w_int8 * 2^-exp, exp int32.

    ``floor(log2(y))`` is read exactly off ``frexp``'s exponent, so the
    exponent is the same on every device."""
    amax = torch.amax(torch.abs(w), dim=axis, keepdim=True)
    qmax = 2.0 ** (bits - 1) - 1
    _, e = torch.frexp(qmax / torch.clamp(amax, min=1e-30))
    exp = e - 1                                        # floor(log2(y))
    w_q = torch.clamp(torch.round(w * exp2_int(exp)), -qmax - 1, qmax)
    return w_q.to(torch.int8), exp.squeeze(axis).to(torch.int32)


def _plain_or_raise(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cpu":
        raise RuntimeError(f"{what}: no kernel for device {t.device}")


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def qmatmul(x_i8: torch.Tensor, w_i8: torch.Tensor, exp_i32: torch.Tensor,
            *, out_dtype: torch.dtype = torch.float32, bm=None, bn=None,
            bk=None, interpret=None) -> torch.Tensor:
    """int8 power-of-two matmul: y = (x @ w) * 2^-exp, (M, N)
    ``out_dtype`` (f32 or bf16), with an int32 accumulator and the exact
    scale ``exp2_int(-exp)``.  x (M, K) and w (K, N) int8
    (``quantize_pot(w, axis=0)``), exp (N,) int32.  The kernel takes any
    M, K and N, so nothing is padded.  ``bm``, ``bn``, ``bk`` and
    ``interpret``, the reference's TPU tiling and interpret switch, are
    accepted and ignored."""
    x = x_i8.contiguous()
    w = w_i8.contiguous()
    e = exp_i32.to(torch.int32).contiguous()
    if x.is_cuda:
        return qmatmul_kernel(x, w, e, out_dtype=out_dtype)
    _plain_or_raise(x, "qmatmul")
    return qmatmul_plain(x, w, e, out_dtype)


def csd_matvec(x_int: torch.Tensor, w_int=None, planes=None, *, bm=None,
               bn=None, interpret=None) -> torch.Tensor:
    """Bit-exact shift-add CAVM: y = x @ W via CSD digit planes, (M, N)
    int32.  ``planes`` (D, K, N), or ``w_int`` (K, N) to expand here: the
    second positional argument is ``w_int``, as in the reference's
    ``repro.kernels.csd_matvec``, so pass the planes by name.  The kernel
    takes any M, N and K, so nothing is padded.  ``bm``, ``bn`` and
    ``interpret``, the reference's TPU tiling and interpret switch, are
    accepted and ignored."""
    if planes is None:
        planes = csd_expand(w_int)
    planes = torch.as_tensor(planes, device=x_int.device).to(
        torch.int8).contiguous()
    x = x_int.to(torch.int32).contiguous()
    if x.is_cuda:
        return csd_matvec_kernel(x, planes)
    _plain_or_raise(x, "csd_matvec")
    return csd_matvec_plain(x, planes)


def csd_qsweep(x_int: torch.Tensor, planes) -> torch.Tensor:
    """Sweep-mode shift-add matvec: y[q] = x[q] @ W[q] via stacked CSD digit
    planes, every q level in one launch (DESIGN.md 11.4).  ``x_int``:
    (Q, M, K) per-network activations; ``planes``: (Q, D, K, N) at a shared
    depth (:func:`csd_expand_stack`).  (Q, M, N) int32, exact provided
    every network satisfies the sweep engine's CSD accumulator bound
    (``repro_torch.eval.batched.csd_net_accum_bound``)."""
    planes = torch.as_tensor(planes, device=x_int.device).to(
        torch.int8).contiguous()
    x = x_int.to(torch.int32).contiguous()
    if x.is_cuda:
        return csd_qsweep_kernel(x, planes)
    _plain_or_raise(x, "csd_qsweep")
    return csd_qsweep_plain(x, planes)


def _block_table(table: torch.Tensor) -> torch.Tensor:
    """The table as the gather kernel reads it: int32 or int64, contiguous
    (no copy, hence no kernel, for the tables the engines pass)."""
    if table.dtype not in (torch.int32, torch.int64):
        table = table.to(torch.int64)
    return table.contiguous()


def paged_gather(leaf: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Block-paged KV gather: (NB, bs, H, D) pool + (B, nb) block table ->
    (B, nb, bs, H, D) logical rows.  Sentinel entries >= NB read block
    NB - 1, like ``index_select`` on the clamped table; the garbage they
    read is masked downstream.  The CUDA kernel maps them itself and is
    bit-identical to the plain version (it is a copy)."""
    if leaf.is_cuda:
        return paged_gather_kernel(leaf, _block_table(table))
    _plain_or_raise(leaf, "paged_gather")
    return paged_gather_plain(
        leaf, torch.clamp(table.to(torch.int64), max=leaf.shape[0] - 1))


def paged_gather_pair(k_leaf: torch.Tensor, v_leaf: torch.Tensor,
                      table: torch.Tensor):
    """:func:`paged_gather` of a layer's K and V leaves through one table:
    on the card one launch of the pair kernel, bit-identical to two
    gathers."""
    if k_leaf.is_cuda:
        return paged_gather_pair_kernel(k_leaf, v_leaf, _block_table(table))
    _plain_or_raise(k_leaf, "paged_gather_pair")
    tbl = torch.clamp(table.to(torch.int64), max=k_leaf.shape[0] - 1)
    return paged_gather_plain(k_leaf, tbl), paged_gather_plain(v_leaf, tbl)


def paged_attention(q, k_pool, v_pool, table, cache_len, *, window: int = 0):
    """Fused block-paged decode attention: softmax(q K^T) V computed
    straight from the (NB, bs, Hkv, D) block pool through the (B, nb)
    block table, with no gathered intermediate.

    Sentinel entries >= NB clamp to NB - 1; the clamped garbage is exactly
    masked because sentinel entries only exist at logical blocks past
    ``cache_len``.  ``cache_len`` is clamped to ``nb * bs``.  The kernel
    bounds its own walk at ``ceil(cache_len / bs)`` blocks; for the plain
    version the effective table repeats each slot's last needed block past
    its length (the TPU kernel's revisit skip; the plain version reads
    masked blocks as exact no-ops)."""
    B = q.shape[0]
    NB, bs = k_pool.shape[0], k_pool.shape[1]
    nb = table.shape[1]
    clen = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device)
    clen = torch.clamp(clen.reshape(-1).expand(B), max=nb * bs).contiguous()
    tbl = torch.clamp(table.to(torch.int32), max=NB - 1).contiguous()
    if q.is_cuda:
        return paged_attention_kernel(q, k_pool, v_pool, tbl, clen,
                                      window=window)
    _plain_or_raise(q, "paged_attention")
    last = torch.clamp(torch.div(clen - 1, bs, rounding_mode="floor"), min=0)
    jidx = torch.minimum(torch.arange(nb, device=q.device)[None, :],
                         last[:, None].to(torch.int64))
    eff = torch.gather(tbl, 1, jidx).contiguous()
    return paged_attention_plain(q, k_pool, v_pool, eff, clen, window=window)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    bk: int = 256, offset=None, bq=None, interpret=None):
    """Flash attention for any Sq / Skv: q (B, Sq, Hq, D), k/v
    (B, Skv, Hkv, D), every key real, query row i at position
    ``i + offset`` (default ``Skv - Sq``).  ``bk`` is the key tile; it
    only matters to a row that sees no key (see
    ``kernels/flash_attention.py``).  ``bq`` and ``interpret``, the
    reference's TPU query tile and interpret switch, are accepted and
    ignored.

    On CUDA tensors that need a gradient (grad mode on, an input requiring
    it) the call goes through :class:`~repro_torch.kernels.flash_attention.
    FlashAttention`, the forward kernel writing its rows' lse and the
    backward kernels reading it; otherwise it is one forward launch with
    no lse.  On the CPU autograd differentiates the plain version, as XLA
    differentiates the reference's scan."""
    Sq, Skv = q.shape[1], k.shape[1]
    kw = dict(causal=causal, window=window, kv_len=Skv,
              offset=Skv - Sq if offset is None else offset, bk=bk)
    if q.is_cuda:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if not _needs_grad(q, k, v):
            return flash_attention_kernel(q, k, v, **kw)
        return FlashAttention.apply(q, k, v, kw)
    _plain_or_raise(q, "flash_attention")
    return flash_attention_plain(q, k, v, **kw)


def linear_scan(a: torch.Tensor, x: torch.Tensor, *, bt=None, bw=None,
                interpret=None) -> torch.Tensor:
    """First-order linear recurrence ``h_t = a_t * h_{t-1} + x_t`` with
    ``h_{-1} = 0``: a, x (B, S, W) -> h (B, S, W) f32, for any B, S, W
    (nothing is padded).  The CUDA kernel is bit-identical to the plain
    version.  ``bt``, ``bw`` and ``interpret``, the reference's TPU tiling
    and interpret switch, are accepted and ignored.

    On CUDA tensors that need a gradient the call goes through
    :class:`~repro_torch.kernels.linear_scan.LinearScan`, whose backward
    runs the same kernel backward in time; on the CPU autograd
    differentiates the plain version, as XLA differentiates the
    reference's scan."""
    a = a.to(torch.float32).contiguous()
    x = x.to(torch.float32).contiguous()
    if a.is_cuda:
        if _needs_grad(a, x):
            return LinearScan.apply(a, x)
        return linear_scan_kernel(a, x)
    _plain_or_raise(a, "linear_scan")
    return linear_scan_plain(a, x)


def wkv6(r, k, v, w, u, s0, log_w=None):
    """The RWKV6 WKV recurrence over a sequence (``kernels/wkv6.py``):
    r, k, v (B, S, H, hd) in the dtype the projections give them (f32 or
    bf16, not cast here), the decay (B, S, H, hd) as w or as ``log_w``
    (then w = ``torch.exp(log_w)``; pass w None), u (H, hd), s0 (B, H, hd,
    hd) f32 -> (y (B, S, H, hd) f32, the final state).  The CUDA kernel's
    state is bit-identical to the plain version's, y equal up to the order
    of the hd-term sums.

    On CUDA tensors that need a gradient the call goes through
    :class:`~repro_torch.kernels.wkv6.Wkv6` (the forward kernel, then the
    backward kernel, which gives the gradient of log w: it does not divide
    by w, which underflows to 0), so a gradient through the decay needs it
    as ``log_w`` (ValueError for a w that needs one).  Otherwise it is one
    forward launch.  On the CPU autograd differentiates the plain version,
    as XLA differentiates the reference's scan."""
    if (w is None) == (log_w is None):
        raise ValueError("ops.wkv6 takes the decay as w or as log_w")
    r, k, v = (t.contiguous() for t in (r, k, v))
    u, s0 = (t.to(torch.float32).contiguous() for t in (u, s0))
    if log_w is not None:
        log_w = log_w.to(torch.float32).contiguous()
    if r.is_cuda:
        r, k, v = (_aligned16(t) for t in (r, k, v))
        if log_w is not None and _needs_grad(r, k, v, log_w, u, s0):
            return Wkv6.apply(r, k, v, log_w, u, s0)
        w = _aligned16(torch.exp(log_w) if w is None
                       else w.to(torch.float32).contiguous())
        if not _needs_grad(r, k, v, w, u, s0):
            return wkv6_kernel(r, k, v, w, u, s0)
        if w.requires_grad:
            raise ValueError("ops.wkv6: a gradient through the decay on the "
                             "card needs it as log_w (the backward gives "
                             "the gradient of log w)")
        return Wkv6.apply(r, k, v, None, u, s0, w)
    _plain_or_raise(r, "wkv6")
    return wkv6_plain(r, k, v, torch.exp(log_w) if w is None
                      else w.to(torch.float32).contiguous(), u, s0)


def chain_scan(a, acc, w, bsh, lab, lab_safe, acts, q, k, count0,
               wi, wj, dw, db) -> torch.Tensor:
    """The serial greedy chain over one run of layer-k candidates in one
    launch (``repro_torch.kernels.chain_scan``): (n, 2) int32 of (count,
    accepted).  The caches are read, never written; the CUDA kernel is
    bit-identical to the plain version."""
    args = (a, acc, w, bsh, lab, lab_safe, acts, q, k, count0, wi, wj, dw,
            db)
    if a[k].is_cuda:
        return chain_scan_kernel(*args)
    _plain_or_raise(a[k], "chain_scan")
    return chain_scan_plain(*args)


def tm_chain(a, acc, w, bsh, lab, lab_safe, acts, q, k, count0, dbsh,
             wi, wj, dw0, dw1, has2, valid, pw0, pw1) -> torch.Tensor:
    """The time-multiplexed tuner's decision-tree chain in one launch
    (``repro_torch.kernels.chain_scan``): (n, 6) int32 of (ok, sel,
    pair_ok, db_idx, cnt_best, cnt_dec).  The CUDA kernel is bit-identical
    to the plain version."""
    args = (a, acc, w, bsh, lab, lab_safe, acts, q, k, count0, dbsh,
            wi, wj, dw0, dw1, has2, valid, pw0, pw1)
    if a[k].is_cuda:
        return tm_chain_kernel(*args)
    _plain_or_raise(a[k], "tm_chain")
    return tm_chain_plain(*args)


# The reference's kernel modules also export their ops under the module's
# name (``from repro.kernels.flash_attention import flash_attention``).
# Those modules cannot import this one, which imports them, so the names
# are bound into them here, when the package is first imported.
for _op in (flash_attention, linear_scan, qmatmul, csd_matvec):
    setattr(sys.modules[f"{__package__}.{_op.__name__}"], _op.__name__, _op)
del _op
