"""Attention, dense-FFN and RG-LRU blocks, init + apply style (counterpart
of ``repro/nn/blocks.py``; MoE and RWKV are not ported yet).

Parameters are plain dicts of tensors in the reference's layouts (weights
``(in, out)``); ``lead`` prepends stacking dims, so a model initializes all
its layers in one call per leaf.  Caches are dicts of tensors that the
apply functions update IN PLACE (the reference donates them to XLA
instead).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import (_gather_kv_rows, chunked_attention, decode_attention,
                     paged_decode_attention_ref, rms_norm, rope, swiglu)
from .types import ArchConfig


def _dense(gen, shape, lead=(), scale=None):
    scale = scale or 1.0 / math.sqrt(shape[0])
    return torch.randn((*lead, *shape), generator=gen, device=gen.device,
                       dtype=torch.float32) * scale


def _zeros(gen, shape, lead=()):
    return torch.zeros((*lead, *shape), dtype=torch.float32,
                       device=gen.device)


# ---------------------------------------------------------------------------
# Attention, GQA + optional QKV bias
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ArchConfig, lead=()):
    hd = cfg.head_dim_
    p = {
        "wq": _dense(gen, (cfg.d_model, cfg.n_heads * hd), lead),
        "wk": _dense(gen, (cfg.d_model, cfg.n_kv_heads * hd), lead),
        "wv": _dense(gen, (cfg.d_model, cfg.n_kv_heads * hd), lead),
        "wo": _dense(gen, (cfg.n_heads * hd, cfg.d_model), lead),
    }
    if cfg.qkv_bias:
        p["bq"] = _zeros(gen, (cfg.n_heads * hd,), lead)
        p["bk"] = _zeros(gen, (cfg.n_kv_heads * hd,), lead)
        p["bv"] = _zeros(gen, (cfg.n_kv_heads * hd,), lead)
    return p


def _qkv(p, x, cfg: ArchConfig):
    hd = cfg.head_dim_
    B, S, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    return q, k, v


def attention_seq(p, x, cfg: ArchConfig, *, positions=None, window: int = 0,
                  causal: bool = True, kv_override=None):
    """Full-sequence self-attention (training and prefill).  Every row sees
    its own key, so the reference's block sizes change no result.
    Cross-attention (``kv_override``) comes with the audio family."""
    if kv_override is not None:
        raise NotImplementedError("cross-attention (kv_override) is not "
                                  "ported yet")
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = chunked_attention(q, k, v, causal=causal, window=window)
    return out.reshape(B, S, -1) @ p["wo"].to(x.dtype)


def kv_writes(cache_k, pos, block_table=None):
    """Where one decode token per row lands in a layer's cache.

    Returns ``(rows, index)``: the batch rows whose write lands and the
    cache index tuple it lands at.  The reference scatters with
    ``mode="drop"``; here a write that would be dropped (a sentinel block
    NB, or a logical block past the table) is left out explicitly -- never
    clamped onto a real location.  The plan is the same for every layer,
    so a model computes it once per dispatch."""
    B = pos.shape[0]
    rows = torch.arange(B, device=pos.device)
    if block_table is None:
        return rows, (rows, pos % cache_k.shape[1])
    NB, bs = cache_k.shape[0], cache_k.shape[1]
    nb = block_table.shape[1]
    lb = pos // bs                                            # logical block
    phys = torch.gather(block_table.to(torch.int64), 1,
                        torch.clamp(lb, max=nb - 1)[:, None])[:, 0]
    phys = torch.where(lb < nb, phys, NB)
    keep = torch.nonzero(phys < NB, as_tuple=True)[0]
    return keep, (phys[keep], (pos % bs)[keep])


def attention_step(p, x, cache, pos, cfg: ArchConfig, *, block_table=None,
                   kv_gather: str = "take", decode_kernel: str = "dense",
                   writes=None):
    """One decode token.  cache: {k, v} of one layer, updated in place;
    pos: a per-row (B,) position tensor, or an int shared by every row.

    Contiguous cache (B, C, Hkv, D): row b writes at pos % C.  With
    ``block_table`` (B, nb) the leaves are (NB, bs, Hkv, D) pools: the
    token's K/V lands at (table[b, pos // bs], pos % bs) unless that entry
    is the sentinel (see :func:`kv_writes`; ``writes`` passes its plan in),
    and attention reads the pool per ``decode_kernel``: ``"dense"`` gathers
    the logical rows (``kv_gather``: ``"take"`` or the ``"cuda"`` kernel)
    and runs the dense masked pass; ``"reference"`` runs the
    block-sequential loop; ``"fused"`` runs the fused paged-attention
    kernel.  Returns (output (B, 1, d_model), cache)."""
    B = x.shape[0]
    q, k, v = _qkv(p, x, cfg)
    if not torch.is_tensor(pos):
        if block_table is not None:
            raise ValueError("block-paged attention_step needs per-row pos")
        pos = torch.full((B,), int(pos), dtype=torch.int64, device=x.device)
    posv = pos.to(torch.int64).reshape(B)
    q = rope(q, posv[:, None], cfg.rope_theta)
    k = rope(k, posv[:, None], cfg.rope_theta)
    k_cache, v_cache = cache["k"], cache["v"]
    if writes is None:
        writes = kv_writes(k_cache, posv, block_table)
    rows, index = writes
    k_cache[index] = k[rows, 0].to(k_cache.dtype)
    v_cache[index] = v[rows, 0].to(v_cache.dtype)
    if block_table is not None:
        bs, nb = k_cache.shape[1], block_table.shape[1]
        cache_len = torch.clamp(posv + 1, max=nb * bs)
        if decode_kernel == "dense":
            krow, vrow = _gather_kv_rows(k_cache, v_cache, block_table,
                                         engine=kv_gather)
            out = decode_attention(q, krow, vrow, cache_len)
        elif decode_kernel == "reference":
            out = paged_decode_attention_ref(q, k_cache, v_cache,
                                             block_table, cache_len)
        elif decode_kernel == "fused":
            from repro_torch.kernels import paged_attention
            out = paged_attention(q, k_cache, v_cache, block_table,
                                  cache_len)
        else:
            raise ValueError(f"unknown decode_kernel {decode_kernel!r}")
    else:
        cache_len = torch.clamp(posv + 1, max=k_cache.shape[1])
        out = decode_attention(q, k_cache, v_cache, cache_len)
    out = out.reshape(B, 1, -1) @ p["wo"].to(x.dtype)
    return out, cache


def init_attn_cache(cfg: ArchConfig, batch: int, context: int, *,
                    window: int = 0, dtype=torch.bfloat16, device="cuda"):
    C = min(context, window) if window else context
    shape = (batch, C, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Dense FFN (swiglu)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, f: int, lead=()):
    return {"wg": _dense(gen, (d, f), lead), "wu": _dense(gen, (d, f), lead),
            "wd": _dense(gen, (f, d), lead)}


def mlp_apply(p, x):
    return swiglu(x, p["wg"].to(x.dtype), p["wu"].to(x.dtype),
                  p["wd"].to(x.dtype))


# ---------------------------------------------------------------------------
# RG-LRU (recurrentgemma): gated linear recurrence + temporal conv
# ---------------------------------------------------------------------------

def init_rglru(gen: torch.Generator, cfg: ArchConfig, lead=()):
    d, w = cfg.d_model, cfg.rglru_width
    return {
        "w_in_x": _dense(gen, (d, w), lead),        # recurrence branch
        "w_in_g": _dense(gen, (d, w), lead),        # gelu gate branch
        "w_out": _dense(gen, (w, d), lead),
        "conv_k": _dense(gen, (4, w), lead, scale=0.3),  # causal conv, 4
        "gate_i": _dense(gen, (w,), lead, scale=1.0),    # input gate
        "gate_r": _dense(gen, (w,), lead, scale=1.0),    # recurrence gate
        "lam": torch.full((*lead, w), 3.0, dtype=torch.float32,
                          device=gen.device),           # a = sigmoid(lam)
    }


def _rglru_scan(p, u, h0):
    """u: (B, S, w) conv output; h0: (B, w) f32.  Returns (y in u.dtype,
    hS f32).

    The reference's step ``h = a_t h + sqrt(max(1 - a_t^2, 1e-8)) x_t``
    from ``h0`` is the linear scan ``h_t = a_t h_{t-1} + x'_t`` from 0
    with ``x'_t = sqrt(max(1 - a_t^2, 1e-8)) x_t`` and ``a_0 h0`` added to
    ``x'_0``: the same f32 operations.  The scan is the CUDA kernel on a
    CUDA tensor and its plain version on the CPU (``kernels.ops``)."""
    from repro_torch.kernels import linear_scan
    uf = u.float()
    i_t = torch.sigmoid(uf * p["gate_i"])
    r_t = torch.sigmoid(uf * p["gate_r"])
    a = torch.sigmoid(p["lam"])
    # a_t = a^(c r_t) with c = 8 (the paper's RG-LRU exponent scaling)
    a_t = torch.exp(8.0 * r_t * torch.log(torch.clamp(a, min=1e-6)))
    gated = i_t * uf
    xs = torch.sqrt(torch.clamp(1 - a_t * a_t, min=1e-8)) * gated
    xs[:, 0] = xs[:, 0] + a_t[:, 0] * h0
    h = linear_scan(a_t, xs)
    return h.to(u.dtype), h[:, -1]


def rglru_seq(p, x, cfg: ArchConfig, h0=None, conv_state=None):
    """Full recurrent block: in-projection, causal conv of width 4 over
    ``conv_state`` (B, 3, w) and the new inputs, RG-LRU, tanh-GELU-gated
    out-projection.  Returns (out, hS (B, w) f32, the new conv state)."""
    B, S, _ = x.shape
    w = cfg.rglru_width
    u = x @ p["w_in_x"].to(x.dtype)                            # (B, S, w)
    g = F.gelu(x @ p["w_in_g"].to(x.dtype), approximate="tanh")
    if conv_state is None:
        conv_state = torch.zeros((B, 3, w), dtype=x.dtype, device=x.device)
    upad = torch.cat([conv_state, u], dim=1)                   # (B, S+3, w)
    ck = p["conv_k"].to(x.dtype)
    uc = (upad[:, 0:S] * ck[0] + upad[:, 1:S + 1] * ck[1]
          + upad[:, 2:S + 2] * ck[2] + upad[:, 3:S + 3] * ck[3])
    if h0 is None:
        h0 = torch.zeros((B, w), dtype=torch.float32, device=x.device)
    y, hS = _rglru_scan(p, uc, h0)
    out = (y * g) @ p["w_out"].to(x.dtype)
    return out, hS, upad[:, -3:]
