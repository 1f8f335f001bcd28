"""Layer primitives of the model (counterpart of ``repro/nn/layers.py``).

Plain functions on tensors, in the JAX package's layouts: activations
(B, S, H, D), caches (B, C, Hkv, D), block pools (NB, bs, Hkv, D).  Where
the reference contracts with ``preferred_element_type=float32``, the
operands are widened to f32 first: products of bf16 values are exact in
f32, so the contraction is the reference's up to summation order.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def cast(x, dtype: str):
    """``x`` in the dtype the reference names by string (``"bfloat16"``,
    ``"float32"``)."""
    return x.to(getattr(torch, dtype))


def rms_norm(x, scale, eps: float = 1e-6):
    # variance in f32, but the normalization multiply stays in x.dtype,
    # with (1 + scale) -- the reference's cast order
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + scale)


@functools.lru_cache(maxsize=None)
def _rope_freqs(half: int, theta: float, device: torch.device):
    """exp(-i ln(theta) / half) for i < half in f32, computed on the CPU
    and moved to ``device``.  The card's ``expf`` and the CPU's differ in
    the last bit for some i, and at position p that ulp moves the angle p
    times as far (2e-4 of q's and k's largest at p ~ 3000), so every device
    rotates by the one table."""
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32)
                      * (math.log(theta) / half))
    return freqs.to(device)


def rope(x, positions, theta: float = 1e4):
    """Rotary embedding in f32, cast back.  x: (..., S, H, D), positions:
    (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = _rope_freqs(half, theta, x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs   # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                        # over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      block_kv: int = 512, q_offset: int = 0):
    """Online-softmax attention over blocks of ``block_kv`` keys.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); query row i sits at position
    ``q_offset + i``; ``window > 0`` limits it to the last ``window``
    positions.  GQA reads KV head ``h // (Hq // Hkv)``; the repeated K/V
    never materializes.  On a CUDA tensor this is the flash-attention
    kernel, on the CPU its plain version (``repro_torch.kernels.
    flash_attention``), both with this function's contract: every block
    of the kv length is walked, so a row that sees no key averages v over
    all of them as the reference's scan does (its query tiling,
    ``block_q``, changes no result).  Returns (B, Sq, Hq, D)."""
    from repro_torch.kernels import flash_attention
    return flash_attention(q, k, v, causal=causal, window=window,
                           bk=min(block_kv, k.shape[1]), offset=q_offset)


def chunk_cache_attention(q, k_cache, v_cache, q_pos):
    """Prompt-chunk attention against cache rows.

    q: (B, c, Hq, D) chunk queries; caches: (B, C, Hkv, D); q_pos: the
    global positions of the chunk queries, (c,) shared or (B, c) per row
    (the chunk's K/V must already be in the cache).  Each query attends to
    every cache position <= its own; masked positions score exactly
    NEG_INF, whose exp underflows to 0.0 in f32, so garbage at masked
    positions never reaches the output.  GQA is a grouped contraction."""
    B, c, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, c, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_cache.float()) * scale
    q_pos = torch.as_tensor(q_pos, device=q.device)
    kpos = torch.arange(S, device=q.device)
    if q_pos.ndim == 1:
        valid = kpos[None, :] <= q_pos[:, None]                   # (c, S)
        s = torch.where(valid[None, None, None], s, NEG_INF)
    else:
        valid = kpos[None, None, :] <= q_pos[:, :, None]          # (B, c, S)
        s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, c, Hq, D).to(q.dtype)


def gather_block_rows(leaf, table, *, engine: str = "take"):
    """Assemble logical cache rows from a block-paged KV leaf.

    leaf: (NB, bs, ...) block pool; table: (B, nb) block table whose
    entries may carry the sentinel NB for blocks not yet granted (their
    content is garbage the caller's masks hide).  Returns (B, nb*bs, ...).
    ``engine="take"`` is ``index_select`` on the clamped table;
    ``engine="cuda"`` is the paged-gather kernel (its plain version on the
    CPU), bit-identical."""
    NB, bs = leaf.shape[0], leaf.shape[1]
    B, nb = table.shape
    if engine == "cuda":
        from repro_torch.kernels import paged_gather
        out = paged_gather(leaf, table)
    elif engine == "take":
        out = leaf.index_select(
            0, torch.clamp(table.to(torch.int64), max=NB - 1).reshape(-1))
    else:
        raise ValueError(f"unknown gather engine {engine!r}")
    return out.reshape(B, nb * bs, *leaf.shape[2:])


def _gather_kv_rows(k_leaf, v_leaf, table, *, engine: str = "take"):
    """``gather_block_rows`` of a layer's K and V leaves through one table.
    ``engine="cuda"`` gathers both in one launch of the pair kernel (its
    plain version on the CPU), bit-identical to two gathers."""
    if engine != "cuda":
        return (gather_block_rows(k_leaf, table, engine=engine),
                gather_block_rows(v_leaf, table, engine=engine))
    from repro_torch.kernels import paged_gather_pair
    B, nb = table.shape
    rows = (B, nb * k_leaf.shape[1], *k_leaf.shape[2:])
    k, v = paged_gather_pair(k_leaf, v_leaf, table)
    return k.reshape(rows), v.reshape(rows)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0):
    """Single-token attention against a cache.

    q: (B, 1, Hq, D); caches: (B, S, Hkv, D); cache_len: scalar or (B,)
    valid length (the new token's K/V already written at cache_len - 1).
    GQA is a grouped contraction; head-repeated K/V never materializes."""
    B, _, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, 1, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)
    clen = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = pos[None, :] < clen
    if window:
        valid &= pos[None, :] >= clen - window
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def paged_decode_attention_ref(q, k_pool, v_pool, table, cache_len, *,
                               window: int = 0):
    """Single-token attention straight from the block-paged KV pool: the
    block-sequential online-softmax loop that is also the fused kernel's
    plain version (``repro_torch.kernels.paged_attention``).  No
    (B, nb*bs, Hkv, D) contiguous copy is made."""
    from repro_torch.kernels.paged_attention import paged_attention_plain
    return paged_attention_plain(q, k_pool, v_pool, table, cache_len,
                                 window=window)


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x @ w_in + b_in, approximate="tanh") @ w_out + b_out
