"""Attention, dense-FFN, MoE, RWKV6 and RG-LRU blocks, init + apply style
(counterpart of ``repro/nn/blocks.py``).

Parameters are plain dicts of tensors in the reference's layouts (weights
``(in, out)``); ``lead`` prepends stacking dims, so a model initializes all
its layers in one call per leaf.  Caches are dicts of tensors that the
apply functions update IN PLACE (the reference donates them to XLA
instead).
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from .layers import (_gather_kv_rows, chunked_attention, decode_attention,
                     paged_decode_attention_ref, rms_norm, rope, swiglu)
from .types import ArchConfig


# ``Model.init``'s stand-in for a generator on the meta device, where no
# ``torch.Generator`` lives: draws there make shapes and dtypes only
META_DRAWS = SimpleNamespace(device=torch.device("meta"))


def randn(gen, shape):
    """f32 standard normal draws of ``shape`` from ``gen`` on its device
    (``META_DRAWS``: meta tensors, nothing drawn)."""
    return torch.randn(shape, generator=None if gen is META_DRAWS else gen,
                       device=gen.device, dtype=torch.float32)


def _dense(gen, shape, lead=(), scale=None):
    scale = scale or 1.0 / math.sqrt(shape[0])
    # scaled in place: an expert leaf is 15.5 GiB at full width
    return randn(gen, (*lead, *shape)).mul_(scale)


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


def kv_proj(p, src, cfg: ArchConfig):
    """K and V of ``src`` (B, F, d), the cross-attention's keys and values:
    (B, F, Hkv, hd) each, with the optional bias and no rope."""
    hd = cfg.head_dim_
    B, F_, _ = src.shape
    k = src @ p["wk"].to(src.dtype)
    v = src @ p["wv"].to(src.dtype)
    if "bk" in p:
        k = k + p["bk"].to(src.dtype)
        v = v + p["bv"].to(src.dtype)
    return (k.reshape(B, F_, cfg.n_kv_heads, hd),
            v.reshape(B, F_, cfg.n_kv_heads, hd))


def attention_seq(p, x, cfg: ArchConfig, *, positions=None, window: int = 0,
                  causal: bool = True, kv_override=None):
    """Full-sequence attention (training and prefill).  Every row sees its
    own key, so the reference's block sizes change no result.
    ``kv_override`` = (k, v) makes it cross-attention: q unroped against
    those keys and values (:func:`kv_proj`), non-causal whatever
    ``causal`` says."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg)
    if kv_override is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    else:
        k, v = kv_override     # cross-attention: no rope
    out = chunked_attention(q, k, v, causal=causal and kv_override is None,
                            window=window)
    return out.reshape(B, S, -1) @ p["wo"].to(x.dtype)


def cross_attention_step(p, x, cross_k, cross_v, cfg: ArchConfig):
    """One decode token's cross-attention: x (B, 1, d) against every
    frame of one layer's ``cross_k`` / ``cross_v`` (B, F, Hkv, hd), q
    unroped.  Returns (B, 1, d_model)."""
    B = x.shape[0]
    q = x @ p["wq"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(B, 1, cfg.n_heads, cfg.head_dim_)
    out = decode_attention(q, cross_k, cross_v, cross_k.shape[1])
    return out.reshape(B, 1, -1) @ p["wo"].to(x.dtype)


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
# MoE FFN: top-k routing, capacity-bounded gather dispatch
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ArchConfig, lead=()):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    # the experts' fan-in is their leading dim E, as in the reference
    p = {
        "router": _dense(gen, (d, E), lead),
        "wg": _dense(gen, (E, d, f), lead),
        "wu": _dense(gen, (E, d, f), lead),
        "wd": _dense(gen, (E, f, d), lead),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, d, f * cfg.n_shared_experts, lead)
    if cfg.moe_dense_residual:
        p["dense"] = init_mlp(gen, d, cfg.dense_ff, lead)
    return p


def moe_capacity(cfg: ArchConfig, S: int) -> int:
    """Slots per expert and batch row for S routed positions:
    ``min(max(4, ceil(capacity_factor * S * K / E)), S)``, in the
    reference's float order."""
    C = max(4, int(math.ceil(cfg.capacity_factor * S * cfg.top_k
                             / cfg.n_experts)))
    return min(C, S)


def moe_route(probs: torch.Tensor, K: int, C: int):
    """Top-K routing with capacity C of router probabilities ``probs``
    (B, S, E) f32.

    Returns ``(gate (B, S, K) f32, expert_idx (B, S, K) int64, keep
    (B, S*K) bool, slot (B, S*K) int64)``.  The top K come from a stable
    descending sort, so among equal probabilities the lower expert index
    comes first, as ``lax.top_k`` orders them (``torch.topk`` promises no
    order on ties).  The gates are normalized by ``max(sum, 1e-9)``.  A
    (token, k) pair's place in its expert is a running count over the
    token-major flattening (B, S*K); it keeps its slot ``e * C + pos``
    while pos < C, else it goes to the drop slot E * C."""
    B, S, E = probs.shape
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_idx = vals[..., :K], idx[..., :K]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat_e = expert_idx.reshape(B, S * K)
    onehot = flat_e[..., None] == torch.arange(E, device=probs.device)
    pos = torch.gather(torch.cumsum(onehot, dim=1), 2,
                       flat_e[..., None])[..., 0] - 1          # 0-based
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos, E * C)
    return gate, expert_idx, keep, slot


def moe_slot_table(slot: torch.Tensor, S: int, n_slots: int):
    """The token of every slot and whether a kept pair fills it, (B,
    n_slots) int64 and bool, from ``slot`` (B, S*K) of ``moe_route``
    (``n_slots`` = E * C; the drop slot n_slots is the only one that takes
    duplicate writes, and it is cut off)."""
    B, SK = slot.shape
    token = torch.arange(S, device=slot.device).repeat_interleave(SK // S)
    table = torch.zeros((B, n_slots + 1), dtype=torch.int64,
                        device=slot.device)
    table.scatter_(1, slot, token.expand(B, -1))
    filled = torch.zeros((B, n_slots + 1), dtype=torch.bool,
                         device=slot.device)
    filled.scatter_(1, slot, True)
    return table[:, :n_slots], filled[:, :n_slots]


class MoeDispatch(torch.autograd.Function):
    """The expert dispatch ``xe[b, j] = x[b, idx[b, j]]`` where slot j is
    filled, else 0, with a gradient free of atomics.

    Every filled slot holds one kept (token, k) pair, so the gradient of a
    token is the sum of its K slots' gradients: ``dx[b, s] = sum_k keep[b,
    s*K+k] * dxe[b, slot[b, s*K+k]]``, gathered through ``slot`` (the drop
    slot clamped into range, then masked out) and added in k order.  The
    forward is ``torch.gather`` and the mask, the same ops as without the
    Function; autograd through that gather would scatter-add the slots'
    gradients into dx instead, in an order that varies on the card."""

    @staticmethod
    def forward(ctx, x, idx, filled, slot, keep):
        """x (B, S, d); idx, filled (B, E*C); slot, keep (B, S*K)."""
        B, S, d = x.shape
        xe = torch.gather(x, 1, idx[..., None].expand(B, idx.shape[1], d))
        ctx.save_for_backward(slot, keep)
        ctx.S, ctx.n_slots = S, idx.shape[1]
        return torch.where(filled[..., None], xe, 0)

    @staticmethod
    def backward(ctx, dxe):
        slot, keep = ctx.saved_tensors
        B, SK = slot.shape
        d, S = dxe.shape[-1], ctx.S
        rows = torch.clamp(slot, max=ctx.n_slots - 1)[..., None]
        g = torch.gather(dxe, 1, rows.expand(B, SK, d))
        g = torch.where(keep[..., None], g, 0).reshape(B, S, SK // S, d)
        dx = g[:, :, 0]
        for k in range(1, SK // S):
            dx = dx + g[:, :, k]
        return dx, None, None, None, None


def moe_apply(p, x, cfg: ArchConfig):
    """x: (B, S, d).  Capacity-bounded top-k dispatch by gather and
    scatter, every expert computed over its C slots (the reference's
    three einsums over all E experts); pairs past an expert's capacity
    are dropped.  Adds the shared experts' MLP and arctic's dense
    residual.  Returns (y in x.dtype, the Switch load-balance loss aux,
    0-d f32).  Under autograd the routing's integers carry no gradient:
    the router's comes through the gates (the sort's values) and through
    aux's importance term, as in the reference; the dispatch's is
    ``MoeDispatch``'s."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = moe_capacity(cfg, S)
    # the router matmul in the model dtype; only the logits go to f32
    logits = (x @ p["router"].to(x.dtype)).float()                # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx, keep, slot = moe_route(probs, K, C)

    idx, filled = moe_slot_table(slot, S, E * C)
    xe = MoeDispatch.apply(x, idx, filled, slot, keep).reshape(B, E, C, d)
    h = torch.einsum("becd,edf->becf", xe, p["wg"].to(x.dtype))
    u = torch.einsum("becd,edf->becf", xe, p["wu"].to(x.dtype))
    ye = torch.einsum("becf,efd->becd", F.silu(h) * u,
                      p["wd"].to(x.dtype))                      # (B,E,C,d)

    # combine: each (token, k) gathers its slot's output (zero if dropped);
    # its backward scatters into one slot a kept pair, and only the drop
    # row, cut off, takes several
    ye_flat = torch.cat([ye.reshape(B, E * C, d),
                         torch.zeros((B, 1, d), dtype=ye.dtype,
                                     device=x.device)], dim=1)
    tok_out = torch.gather(ye_flat, 1, slot[..., None].expand(B, S * K, d))
    w = gate.to(x.dtype) * keep.reshape(B, S, K)
    y = torch.einsum("bskd,bsk->bsd", tok_out.reshape(B, S, K, d), w)

    if cfg.n_shared_experts:
        y = y + mlp_apply(p["shared"], x)
    if cfg.moe_dense_residual:
        y = y + mlp_apply(p["dense"], x)
    # auxiliary load-balance loss (Switch): E * sum(f_e * p_e); the counts
    # are exact in f32 in any order of the adds (bincount would wait on the
    # card for its output's length)
    flat = expert_idx.reshape(-1)
    frac = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=x.device)) / flat.numel()
    imp = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac * imp)
    return y.to(x.dtype), aux


# ---------------------------------------------------------------------------
# RWKV6 ("Finch"): data-dependent decay linear attention + channel mix
# ---------------------------------------------------------------------------

def init_rwkv(gen: torch.Generator, cfg: ArchConfig, lead=()):
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = d // hd
    lora = 64

    def full(shape, value):
        return torch.full((*lead, *shape), value, dtype=torch.float32,
                          device=gen.device)
    return {
        "mu": full((5, d), 0.5),                  # r,k,v,g,w token-shift
        "wr": _dense(gen, (d, d), lead), "wk": _dense(gen, (d, d), lead),
        "wv": _dense(gen, (d, d), lead), "wg": _dense(gen, (d, d), lead),
        "wo": _dense(gen, (d, d), lead),
        "w0": full((d,), -6.0),                   # decay base
        "wA": _dense(gen, (d, lora), lead), "wB": _dense(gen, (lora, d), lead),
        "u": _zeros(gen, (H, hd), lead),          # bonus
        "ln_x": _zeros(gen, (d,), lead),
        "cm_mu": full((2, d), 0.5),
        "cm_k": _dense(gen, (d, cfg.d_ff), lead),
        "cm_v": _dense(gen, (cfg.d_ff, d), lead),
    }


def _token_shift(x, x_prev):
    """x shifted one token later along S, ``x_prev`` (B, d) in front."""
    return torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _rwkv_proj(p, x, x_prev, cfg: ArchConfig):
    """Token-shift mixes + projections.  x: (B, S, d); x_prev: (B, d), the
    token before x[:, 0].  Returns r, k, v, g in x.dtype and the decay's
    log, log w = -exp(w0 + tanh(mix_w @ wA) @ wB), in f32 whatever
    x.dtype, as the reference casts: exp(log w) is the reference's w =
    exp(-exp(...)) bit for bit, since negation is exact."""
    mu = p["mu"].to(x.dtype)
    xs = _token_shift(x, x_prev)
    mix = [x + (xs - x) * mu[i] for i in range(5)]
    r = mix[0] @ p["wr"].to(x.dtype)
    k = mix[1] @ p["wk"].to(x.dtype)
    v = mix[2] @ p["wv"].to(x.dtype)
    g = F.silu(mix[3] @ p["wg"].to(x.dtype))
    dd = p["w0"].float() + (torch.tanh(mix[4].float() @ p["wA"].float())
                            @ p["wB"].float())
    return r, k, v, g, -torch.exp(dd)                          # (B, S, d)


def rwkv_time_mix_seq(p, x, cfg: ArchConfig, state=None, x_prev=None):
    """The time mix over x (B, S, d) from ``state`` (B, H, hd, hd) f32 and
    the last token before it ``x_prev`` (zeros when None): the WKV
    recurrence (``kernels.wkv6``: the CUDA kernel on a CUDA tensor, its
    plain version on the CPU), ``rms_norm`` over the whole d with
    ``ln_x``, the gate g and ``wo``.  Returns (y, the new state, x[:, -1])."""
    from repro_torch.kernels import wkv6
    B, S, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    if x_prev is None:
        x_prev = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    if state is None:
        state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                            device=x.device)
    r, k, v, g, lw = _rwkv_proj(p, x, x_prev, cfg)
    r, k, v, lw = (t.reshape(B, S, H, hd) for t in (r, k, v, lw))
    out, state = wkv6(r, k, v, None, p["u"], state, log_w=lw)
    y = out.reshape(B, S, d).to(x.dtype)
    y = rms_norm(y, p["ln_x"].to(x.dtype), cfg.norm_eps)
    y = (y * g) @ p["wo"].to(x.dtype)
    return y, state, x[:, -1]


def rwkv_channel_mix(p, x, x_prev=None):
    """The channel mix: token shift with ``cm_mu[0]``, then
    relu(xk @ cm_k)^2 @ cm_v.  Returns (y, x[:, -1])."""
    B, S, d = x.shape
    if x_prev is None:
        x_prev = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    mu = p["cm_mu"].to(x.dtype)
    xs = _token_shift(x, x_prev)
    xk = x + (xs - x) * mu[0]
    k = torch.square(F.relu(xk @ p["cm_k"].to(x.dtype)))
    return k @ p["cm_v"].to(x.dtype), x[:, -1]


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
