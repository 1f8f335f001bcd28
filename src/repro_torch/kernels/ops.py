"""Public wrappers around the kernels, and the quantization helper that
connects them to ``repro_torch.quant`` (counterpart of
``repro/kernels/ops.py``).

A wrapper given CUDA tensors launches its CUDA kernel or raises; it takes
the kernel's plain PyTorch version only for tensors on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.csd import to_csd_array

from .csd_matvec import (csd_matvec_kernel, csd_matvec_plain,
                         csd_qsweep_kernel, csd_qsweep_plain)
from .paged_attention import paged_attention_kernel, paged_attention_plain
from .paged_gather import paged_gather_kernel, paged_gather_plain

__all__ = ["quantize_pot", "exp2_int", "paged_gather", "paged_attention",
           "csd_expand", "csd_expand_stack", "csd_matvec", "csd_qsweep"]


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


def csd_matvec(x_int: torch.Tensor, w_int=None, planes=None) -> torch.Tensor:
    """Bit-exact shift-add CAVM: y = x @ W via CSD digit planes, (M, N)
    int32.  ``planes`` (D, K, N), or ``w_int`` (K, N) to expand here.  The
    kernel takes any M, N and K, so nothing is padded."""
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


def paged_gather(leaf: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Block-paged KV gather: (NB, bs, H, D) pool + (B, nb) block table ->
    (B, nb, bs, H, D) logical rows.  Sentinel entries >= NB clamp to
    NB - 1, like ``index_select`` on the clamped table; the garbage they
    read is masked downstream.  The CUDA kernel is bit-identical to the
    plain version (it is a copy)."""
    tbl = torch.clamp(table.to(torch.int32), max=leaf.shape[0] - 1)
    if leaf.is_cuda:
        return paged_gather_kernel(leaf, tbl)
    _plain_or_raise(leaf, "paged_gather")
    return paged_gather_plain(leaf, tbl)


def paged_attention(q, k_pool, v_pool, table, cache_len, *, window: int = 0):
    """Fused block-paged decode attention: softmax(q K^T) V computed
    straight from the (NB, bs, Hkv, D) block pool through the (B, nb)
    block table, with no gathered intermediate.

    Sentinel entries >= NB clamp to NB - 1; the clamped garbage is exactly
    masked because sentinel entries only exist at logical blocks past
    ``cache_len``.  ``cache_len`` is clamped to ``nb * bs``, and the
    effective table repeats each slot's last needed block past its length
    (the TPU kernel's revisit skip; here the kernel's loop stops at that
    block and the plain version reads masked blocks as exact no-ops)."""
    B = q.shape[0]
    NB, bs = k_pool.shape[0], k_pool.shape[1]
    nb = table.shape[1]
    clen = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device)
    clen = torch.clamp(clen.reshape(-1).expand(B), max=nb * bs).contiguous()
    tbl = torch.clamp(table.to(torch.int32), max=NB - 1)
    last = torch.clamp(torch.div(clen - 1, bs, rounding_mode="floor"), min=0)
    jidx = torch.minimum(torch.arange(nb, device=q.device)[None, :],
                         last[:, None].to(torch.int64))
    eff = torch.gather(tbl, 1, jidx).contiguous()
    if q.is_cuda:
        return paged_attention_kernel(q, k_pool, v_pool, eff, clen,
                                      window=window)
    _plain_or_raise(q, "paged_attention")
    return paged_attention_plain(q, k_pool, v_pool, eff, clen, window=window)
