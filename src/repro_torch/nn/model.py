"""Model assembly for the dense family (counterpart of
``repro/nn/model.py``).

Parameters are a dict tree in the reference's layout: per-layer leaves are
stacked on a leading layer axis (``params["layers"]["attn"]["wq"]`` is
(L, d_model, Hq*hd)), weights are (in, out), and a Python loop over layers
takes the place of ``lax.scan``.  Caches are ``{"k", "v"}`` tensors of
(L, batch, context, Hkv, hd), or (L, n_blocks, block_size, Hkv, hd) when
block-paged; the serving dispatches update them IN PLACE and return the
same dict (the reference donates the cache to XLA instead).

Public surface:
    m = Model(cfg, device="cuda")
    params = m.init(seed)
    loss, metrics = m.loss(params, batch)     # the PTQ search's metric
    logits, cache = m.prefill(params, batch)  # ReferenceEngine: the prompt
    cache = m.init_cache(batch, context)
    logits, cache = m.prefill_chunks(params, cache, tokens, slots, offs, nv)
    logits, cache = m.decode_step(params, cache, tokens, pos)

Nothing here takes a gradient: every entry point runs under
``torch.no_grad``, and the backbone has no rematerialization.
"""
from __future__ import annotations

import numpy as np
import torch

from . import blocks
from .layers import chunk_cache_attention, gather_block_rows, rms_norm, rope
from .types import ArchConfig

__all__ = ["Model", "params_from_jax", "layer_params", "XENT_CHUNK"]

XENT_CHUNK = 512  # positions per cross-entropy chunk (bounds logits memory)


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' "
                           "to run on the CPU")
    return dev


def layer_params(tree, i: int):
    """Layer ``i``'s slice of a stacked per-layer tree (qleaf dicts keep
    their non-tensor fields)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i] if torch.is_tensor(tree) and tree.ndim else tree


def params_from_jax(tree, device="cuda"):
    """The JAX package's parameter pytree (float or a ``quantize_tree``
    qtree), as numpy arrays or anything ``np.asarray`` takes, turned into
    the port's parameters on ``device``: the same dict structure, the same
    layouts and values.  A qleaf's ``bits`` and ``packed`` stay Python
    values."""
    dev = resolve_device(device)

    def conv(key, x):
        if isinstance(x, dict):
            return {k: conv(k, v) for k, v in x.items()}
        if key in ("bits", "packed"):
            return x if isinstance(x, (bool, int)) else np.asarray(x).item()
        return torch.from_numpy(np.array(x)).to(dev)

    return conv(None, tree)


class Model:
    """Dense decoder LM with the reference's parameter and cache layouts."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"repro_torch ports the dense family, not {cfg.family!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)

    # ------------------------------------------------------------------ init
    def init(self, gen) -> dict:
        """Random parameters from a seeded ``torch.Generator`` on the
        model's device (or an int seed for one): the reference's
        initializers and layouts, not its random numbers."""
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=self.device).manual_seed(int(gen))
        cfg = self.cfg
        L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab
        dev = gen.device
        return {
            "embed": torch.randn((V, d), generator=gen, device=dev) * 0.02,
            "final_norm": torch.zeros((d,), device=dev),
            "lm_head": torch.randn((d, V), generator=gen, device=dev) * 0.02,
            "layers": {
                "ln1": torch.zeros((L, d), device=dev),
                "ln2": torch.zeros((L, d), device=dev),
                "attn": blocks.init_attention(gen, cfg, lead=(L,)),
                "mlp": blocks.init_mlp(gen, d, cfg.d_ff, lead=(L,)),
            },
        }

    # ------------------------------------------------------------- forward
    def _decoder_block(self, p, x, *, window: int = 0):
        cfg = self.cfg
        h = rms_norm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
        x = x + blocks.attention_seq(p["attn"], h, cfg, window=window)
        h = rms_norm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
        return x + blocks.mlp_apply(p["mlp"], h)

    def _backbone(self, params, x):
        """Full-sequence trunk (loss / prefill), x: (B, S, d)."""
        cfg = self.cfg
        for i in range(cfg.n_layers):
            x = self._decoder_block(layer_params(params["layers"], i), x)
        return rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)

    def _embed_inputs(self, params, batch):
        """Token embedding; returns (x, labels, loss_mask), the last two
        None without ``batch["labels"]``."""
        x = params["embed"][self._long(batch["tokens"])].to(self.dtype)
        if "labels" not in batch:
            return x, None, None
        labels = self._long(batch["labels"])
        return x, labels, torch.ones(labels.shape, dtype=torch.float32,
                                     device=self.device)

    def _xent(self, params, x, labels, mask):
        """Chunked softmax cross-entropy: one (B, XENT_CHUNK, V) block of
        f32 logits at a time."""
        S = x.shape[1]
        chunk = min(XENT_CHUNK, S)
        head = params["lm_head"].to(self.dtype)
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, S, chunk):
            logits = (x[:, c0:c0 + chunk] @ head).float()
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1,
                                labels[:, c0:c0 + chunk, None])[..., 0]
            del logits
            mc = mask[:, c0:c0 + chunk]
            tot = tot + ((lse - gold) * mc).sum()
            cnt = cnt + mc.sum()
        return tot / torch.clamp(cnt, min=1.0)

    @torch.no_grad()
    def loss(self, params, batch):
        """Mean next-token cross-entropy of ``batch`` ({"tokens", "labels"}
        of (B, S)); returns (loss, {"xent", "aux"}) as 0-d f32 tensors."""
        x, labels, mask = self._embed_inputs(params, batch)
        x = self._backbone(params, x)
        xent = self._xent(params, x, labels, mask)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        return xent + 0.01 * aux, {"xent": xent, "aux": aux}

    @torch.no_grad()
    def prefill(self, params, batch):
        """Ingest whole prompts ``batch["tokens"]`` (B, S); returns
        (last-position logits (B, 1, V) f32, the cache {k, v} of
        (L, B, S, Hkv, hd) with K roped at positions 0..S-1 -- the layout
        :meth:`decode_step` reads)."""
        cfg = self.cfg
        x, _, _ = self._embed_inputs(params, batch)
        B, S, _ = x.shape
        shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim_)
        cache = {"k": torch.empty(shape, dtype=x.dtype, device=self.device),
                 "v": torch.empty(shape, dtype=x.dtype, device=self.device)}
        positions = torch.arange(S, device=self.device)[None, :]
        for i in range(cfg.n_layers):
            pl = layer_params(params["layers"], i)
            # the reference recomputes the layer's K/V for the cache
            hn = rms_norm(x, pl["ln1"].to(x.dtype), cfg.norm_eps)
            _, k, v = blocks._qkv(pl["attn"], hn, cfg)
            cache["k"][i] = rope(k, positions, cfg.rope_theta)
            cache["v"][i] = v
            x = self._decoder_block(pl, x)
        x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
        logits = x[:, -1:] @ params["lm_head"].to(x.dtype)
        return logits.float(), cache

    # -------------------------------------------------------------- serving
    def init_cache(self, batch: int, context: int) -> dict:
        """Zeroed decode cache: {k, v} of (L, batch, context, Hkv, hd)."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, context, cfg.n_kv_heads, cfg.head_dim_)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device)}

    def _long(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(torch.int64)

    @torch.no_grad()
    def prefill_chunks(self, params, cache, tokens, slots, offsets, n_valid,
                       block_table=None, kv_gather: str = "take"):
        """Batched chunked prompt ingestion into MANY slots of a paged cache.

        tokens: (P, c) right-padded chunks of up to P different prompts;
        ``slots``/``offsets``/``n_valid``: (P,) -- row i's cache slot, the
        global position of tokens[i, 0], and its real token count.  Writes
        each row's chunk K/V into its own slot IN PLACE and returns (per-row
        logits at the last valid position, (P, V) f32; the cache).

        Writes that the reference drops (``mode="drop"``) are left out
        explicitly: a position >= context, or a sentinel block NB.  Dummy
        rows pass offset = context so every write drops; their logits are
        ignored.  Padded tail positions of real rows are written but land
        beyond every real query position, so the chunk attention masks
        them and later writes overwrite them.

        ``block_table`` ((n_slots, nb) with sentinel NB) switches the cache
        leaves to the (NB, bs, Hkv, D) block pool: writes land at
        (table[slot, p // bs], p % bs), and reads gather the logical rows
        (``kv_gather``: ``"take"`` or the ``"cuda"`` kernel)."""
        cfg = self.cfg
        tokens = self._long(tokens)
        slots, offsets = self._long(slots), self._long(offsets)
        n_valid = self._long(n_valid)
        P, c = tokens.shape
        x = params["embed"][tokens].to(self.dtype)                # (P, c, d)
        positions = offsets[:, None] + torch.arange(c, device=self.device)
        if block_table is None:
            keep = positions < cache["k"].shape[2]
            rows, cols = torch.nonzero(keep, as_tuple=True)
            index = (slots[rows], positions[rows, cols])
        else:
            NB, bs = cache["k"].shape[1], cache["k"].shape[2]
            tbl = self._long(block_table)[slots]                  # (P, nb)
            nb = tbl.shape[1]
            lb = positions // bs
            phys = torch.gather(tbl, 1, torch.clamp(lb, max=nb - 1))
            phys = torch.where(lb < nb, phys, NB)
            rows, cols = torch.nonzero(phys < NB, as_tuple=True)
            index = (phys[rows, cols], (positions % bs)[rows, cols])
        for i in range(cfg.n_layers):
            pl = layer_params(params["layers"], i)
            kc, vc = cache["k"][i], cache["v"][i]
            hn = rms_norm(x, pl["ln1"].to(x.dtype), cfg.norm_eps)
            q, k, v = blocks._qkv(pl["attn"], hn, cfg)
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
            kc[index] = k[rows, cols].to(kc.dtype)
            vc[index] = v[rows, cols].to(vc.dtype)
            if block_table is None:
                krow, vrow = kc[slots], vc[slots]                 # (P, C, ...)
            else:
                krow = gather_block_rows(kc, tbl, engine=kv_gather)
                vrow = gather_block_rows(vc, tbl, engine=kv_gather)
            a = chunk_cache_attention(q, krow, vrow, positions)
            x = x + a.reshape(P, c, -1) @ pl["attn"]["wo"].to(x.dtype)
            hn = rms_norm(x, pl["ln2"].to(x.dtype), cfg.norm_eps)
            x = x + blocks.mlp_apply(pl["mlp"], hn)
        x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
        idx = torch.clamp(n_valid - 1, 0, c - 1)
        xl = x[torch.arange(P, device=self.device), idx]           # (P, d)
        logits = xl @ params["lm_head"].to(x.dtype)
        return logits.float(), cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, pos, block_table=None,
                    kv_gather: str = "take", decode_kernel: str = "dense"):
        """One token for the whole batch.  tokens: (B, 1); pos: an int or a
        (B,) per-row position vector (paged serving).  ``block_table``
        switches the KV leaves to the block pool and ``decode_kernel`` picks
        its attention route (see :func:`repro_torch.nn.blocks.
        attention_step`).  Updates the cache IN PLACE; returns ((B, 1, V)
        f32 logits, the cache)."""
        cfg = self.cfg
        tokens = self._long(tokens)
        B = tokens.shape[0]
        x = params["embed"][tokens].to(self.dtype)                 # (B, 1, d)
        if block_table is not None:
            block_table = self._long(block_table)
        if torch.is_tensor(pos) or np.ndim(pos):
            pos = self._long(pos).reshape(B)
            writes = blocks.kv_writes(cache["k"][0], pos, block_table)
        elif block_table is not None:
            raise ValueError("block-paged decode needs per-row pos")
        else:
            writes = None              # one shared int position: no lookup
        for i in range(cfg.n_layers):
            pl = layer_params(params["layers"], i)
            kv = {"k": cache["k"][i], "v": cache["v"][i]}
            hn = rms_norm(x, pl["ln1"].to(x.dtype), cfg.norm_eps)
            a, _ = blocks.attention_step(
                pl["attn"], hn, kv, pos, cfg, block_table=block_table,
                kv_gather=kv_gather, decode_kernel=decode_kernel,
                writes=writes)
            x = x + a
            hn = rms_norm(x, pl["ln2"].to(x.dtype), cfg.norm_eps)
            x = x + blocks.mlp_apply(pl["mlp"], hn)
        x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
        logits = x @ params["lm_head"].to(x.dtype)
        return logits.float(), cache
