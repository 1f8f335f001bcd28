"""Model assembly for the dense, MoE, RWKV6 (``ssm``), hybrid, audio and
VLM families (counterpart of ``repro/nn/model.py``).

Parameters are a dict tree in the reference's layout: per-layer leaves are
stacked on a leading layer axis (``params["layers"]["attn"]["wq"]`` is
(L, d_model, Hq*hd)), weights are (in, out), and a Python loop over layers
takes the place of ``lax.scan``.  Dense and MoE caches are ``{"k", "v"}``
tensors of (L, batch, context, Hkv, hd), or (L, n_blocks, block_size, Hkv,
hd) when block-paged; the serving dispatches update them IN PLACE and
return the same dict (the reference donates the cache to XLA instead).

The MoE family (qwen2-moe, arctic) is the dense decoder with
``params["layers"]["moe"]`` (router, the experts' (L, E, d, f) leaves, the
shared experts' and the dense residual's MLPs) in place of ``"mlp"``.  Its
routing capacity is counted over the positions of one call: the whole
padded sequence in ``loss`` and ``prefill``, one chunk row in
``prefill_chunks`` (so chunking can change which pairs are dropped, the
reference's chunked-prefill capacity caveat), one token in decode.

The ssm family (rwkv6) is attention-free: each layer of
``params["layers"]`` (the :func:`~repro_torch.nn.blocks.init_rwkv` leaves,
stacked) runs a time mix and a channel mix, each on its rms-normed input.
Its cache is fixed-size whatever the context: ``state`` (L, B, H, hd, hd)
f32, the WKV recurrence's, and ``tm_prev`` / ``cm_prev`` (L, B, d), the
last normed input of each mix (the token shift's previous token).

The hybrid family (recurrentgemma) stacks units of (RG-LRU, RG-LRU, local
attention), each block followed by an MLP, on ``params["layers"]`` (one
entry per unit), and ``n_layers % 3`` RG-LRU tail layers as the list
``params["tail"]``.  Its cache holds each unit's recurrent states
``h1``/``h2`` (n_units, B, w) f32 and conv states ``c1``/``c2``
(n_units, B, 3, w), the local attention's K/V as a ring of
``min(context, local_window)`` slots (position p in slot p % W), and
``tail_h``/``tail_c`` for the tail.

The audio family (whisper) is an encoder-decoder over frame embeddings
``batch["frames"]`` (B, F, d): ``params["enc_layers"]`` are decoder
layers run non-causally over the frames (rope at positions 0..F-1), then
``params["enc_norm"]``; each of ``params["layers"]`` runs causal
self-attention (``ln1``, ``attn``), cross-attention to the encoder
output (``ln_x``, ``xattn``: q unroped against :func:`~repro_torch.nn.
blocks.kv_proj` of it) and the MLP (``ln2``, ``mlp``).  Its cache is the
dense {k, v} plus each layer's cross-attention K/V, ``cross_k`` /
``cross_v`` (L, B, F, Hkv, hd), which decode reads and never writes.

The VLM family (llava-next) is the dense decoder over projected patch
embeddings followed by tokens: ``batch["patch_embeds"]`` (B, P, 1024) @
``params["vision_proj"]`` (1024, d) goes in front of the token embeddings,
so positions 0..P-1 are the patches.  The loss counts the text positions
only; the cache is the dense {k, v}, filled by ``prefill`` at positions
0..P+T-1, and decode embeds tokens only.

Public surface:
    m = Model(cfg, device="cuda")
    params = m.init(seed)
    loss, metrics = m.loss(params, batch)     # the PTQ search's metric
    logits, cache = m.prefill(params, batch)  # ReferenceEngine: the prompt
                                              # (audio: and its frames; vlm:
                                              # and its patch embeddings)
    cache = m.init_cache(batch, context)
    logits, cache = m.prefill_chunks(params, cache, tokens, slots, offs, nv)
    logits, cache = m.prefill_chunk(params, cache, tokens, slot, off, nv)
    logits, cache = m.decode_step(params, cache, tokens, pos)

``loss`` takes a gradient (``runtime/step.py``): on the card every
attention call goes through the flash kernel, whose gradient is the flash
backward kernel, and every RG-LRU scan through the linear-scan kernel,
whose gradient is the same kernel run backward in time.  With ``cfg.remat`` each layer of the trunk runs under
``torch.utils.checkpoint`` (non-reentrant), which recomputes it in the
backward pass, as the reference wraps its scanned layer in
``jax.checkpoint``.  Callers that only score (the PTQ searches,
``serving_ledger``) pass parameters that require no gradient, so no graph
is built.  The serving entry points (``prefill``, ``prefill_chunks``,
``decode_step``) run under ``torch.no_grad``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import blocks
from .layers import _gather_kv_rows, chunk_cache_attention, rms_norm, rope
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


def unstack_layers(tree, n: int) -> list:
    """The ``n`` per-layer slices of a stacked tree, by one ``unbind`` a
    leaf: the same views as ``layer_params``, but the gradient of a stacked
    leaf is then one stack of its layers' gradients, not one leaf-sized
    sum a layer."""
    if isinstance(tree, dict):
        per = {k: unstack_layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    if torch.is_tensor(tree) and tree.ndim:
        return list(torch.unbind(tree, 0))
    return [tree] * n


def params_from_jax(tree, device="cuda"):
    """The JAX package's parameter pytree (float or a ``quantize_tree``
    qtree), as numpy arrays or anything ``np.asarray`` takes, turned into
    the port's parameters on ``device``: the same dict and list structure
    (the hybrid's ``tail`` is a list), the same layouts and values.  A
    qleaf's ``bits`` and ``packed`` stay Python values."""
    dev = resolve_device(device)

    def conv(key, x):
        if isinstance(x, dict):
            return {k: conv(k, v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(key, v) for v in x]
        if key in ("bits", "packed"):
            return x if isinstance(x, (bool, int)) else np.asarray(x).item()
        return torch.from_numpy(np.array(x)).to(dev)

    return conv(None, tree)


class Model:
    """Dense, MoE, RWKV6, hybrid, audio or VLM LM with the reference's
    parameter and cache layouts."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid",
                              "audio"):
            raise NotImplementedError(
                f"repro_torch ports the dense, MoE, VLM, ssm, hybrid and "
                f"audio families, not {cfg.family!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)

    # ------------------------------------------------------------------ init
    def init(self, gen) -> dict:
        """Random parameters from a seeded ``torch.Generator`` on the
        model's device (or an int seed for one): the reference's
        initializers and layouts, not its random numbers.  On the meta
        device (``Model(cfg, device="meta")``) the seed is ignored and the
        leaves are meta tensors: shapes and dtypes, nothing allocated."""
        if self.device.type == "meta":
            gen = blocks.META_DRAWS
        elif not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=self.device).manual_seed(int(gen))
        cfg = self.cfg
        L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab
        dev = gen.device
        params = {
            "embed": blocks.randn(gen, (V, d)) * 0.02,
            "final_norm": torch.zeros((d,), device=dev),
            "lm_head": blocks.randn(gen, (d, V)) * 0.02,
        }
        if cfg.family in ("dense", "moe", "vlm"):
            params["layers"] = self._init_decoder_layers(gen, L)
            if cfg.family == "vlm":
                params["vision_proj"] = blocks.randn(gen, (1024, d)) * 0.02
            return params
        if cfg.family == "audio":
            params["enc_layers"] = self._init_decoder_layers(
                gen, cfg.n_enc_layers)
            params["layers"] = {
                "ln1": torch.zeros((L, d), device=dev),
                "ln_x": torch.zeros((L, d), device=dev),
                "ln2": torch.zeros((L, d), device=dev),
                "attn": blocks.init_attention(gen, cfg, lead=(L,)),
                "xattn": blocks.init_attention(gen, cfg, lead=(L,)),
                "mlp": blocks.init_mlp(gen, d, cfg.d_ff, lead=(L,)),
            }
            params["enc_norm"] = torch.zeros((d,), device=dev)
            return params
        if cfg.family == "ssm":
            params["layers"] = blocks.init_rwkv(gen, cfg, lead=(L,))
            return params
        n_units, rem = divmod(L, 3)
        params["layers"] = self._init_hybrid_unit(gen, lead=(n_units,))
        if rem:
            params["tail"] = [
                {"rg": blocks.init_rglru(gen, cfg),
                 "mlp": blocks.init_mlp(gen, d, cfg.d_ff),
                 "ln1": torch.zeros((d,), device=dev),
                 "ln2": torch.zeros((d,), device=dev)}
                for _ in range(rem)]
        return params

    def _init_decoder_layers(self, gen, n: int) -> dict:
        """``n`` decoder layers stacked on a leading axis: ln1, ln2, attn
        and the MoE (``moe``) or the dense MLP (``mlp``)."""
        cfg = self.cfg
        d = cfg.d_model
        p = {"ln1": torch.zeros((n, d), device=gen.device),
             "ln2": torch.zeros((n, d), device=gen.device),
             "attn": blocks.init_attention(gen, cfg, lead=(n,))}
        if cfg.family == "moe":
            p["moe"] = blocks.init_moe(gen, cfg, lead=(n,))
        else:
            p["mlp"] = blocks.init_mlp(gen, d, cfg.d_ff, lead=(n,))
        return p

    def _init_hybrid_unit(self, gen, lead=()):
        """recurrentgemma unit: 2 RG-LRU blocks then 1 local-attention
        block, each followed by an MLP."""
        cfg = self.cfg
        d = cfg.d_model
        return {
            "rg1": blocks.init_rglru(gen, cfg, lead),
            "rg2": blocks.init_rglru(gen, cfg, lead),
            "attn": blocks.init_attention(gen, cfg, lead),
            "mlp1": blocks.init_mlp(gen, d, cfg.d_ff, lead),
            "mlp2": blocks.init_mlp(gen, d, cfg.d_ff, lead),
            "mlp3": blocks.init_mlp(gen, d, cfg.d_ff, lead),
            "ln": torch.zeros((*lead, 6, d), device=gen.device),
        }

    # ------------------------------------------------------------- forward
    def _remat(self, fn, *args):
        """``fn(*args)``; with ``cfg.remat`` while a graph may be built,
        under ``torch.utils.checkpoint`` (recomputed in the backward pass,
        the reference's ``jax.checkpoint`` of a layer)."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(*args)

    def _ffn(self, p, h):
        """A decoder layer's FFN on its normed input: (y, the MoE's aux
        loss, or None for the dense MLP)."""
        if "moe" in p:
            return blocks.moe_apply(p["moe"], h, self.cfg)
        return blocks.mlp_apply(p["mlp"], h), None

    def _decoder_block(self, p, x, *, window: int = 0, causal: bool = True):
        """Returns (x, aux or None)."""
        cfg = self.cfg
        h = rms_norm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
        x = x + blocks.attention_seq(p["attn"], h, cfg, window=window,
                                     causal=causal)
        h = rms_norm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
        y, aux = self._ffn(p, h)
        return x + y, aux

    def _encode_audio(self, params, frames):
        """The audio encoder over frame embeddings (B, F, d), cast to the
        model dtype first: non-causal, roped self-attention and the MLP a
        layer, then ``enc_norm``."""
        cfg = self.cfg
        x = torch.as_tensor(frames, device=self.device).to(self.dtype)
        block = functools.partial(self._decoder_block, causal=False)
        for p in unstack_layers(params["enc_layers"], cfg.n_enc_layers):
            x, _ = self._remat(block, p, x)
        return rms_norm(x, params["enc_norm"].to(x.dtype), cfg.norm_eps)

    def _cross_block(self, p, x, enc):
        """One audio decoder layer over x (B, S, d) against the encoder
        output ``enc`` (B, F, d): causal self-attention, cross-attention,
        the MLP.  Returns (x, the cross-attention's K, V of ``enc``)."""
        cfg = self.cfg
        h = rms_norm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
        x = x + blocks.attention_seq(p["attn"], h, cfg)
        h = rms_norm(x, p["ln_x"].to(x.dtype), cfg.norm_eps)
        ck, cv = blocks.kv_proj(p["xattn"], enc, cfg)
        x = x + blocks.attention_seq(p["xattn"], h, cfg, causal=False,
                                     kv_override=(ck, cv))
        h = rms_norm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
        return x + blocks.mlp_apply(p["mlp"], h), ck, cv

    def _ssm_block(self, p, x, state=None, tm_prev=None, cm_prev=None):
        """One RWKV6 layer from its carried ``state`` / ``tm_prev`` /
        ``cm_prev`` (zeros when None); returns (x, state, tm_prev,
        cm_prev)."""
        cfg = self.cfg
        h = rms_norm(x, 0.0, cfg.norm_eps)        # the reference's 0-d zero
        y, state, tm_prev = blocks.rwkv_time_mix_seq(p, h, cfg, state,
                                                     tm_prev)
        x = x + y
        h = rms_norm(x, 0.0, cfg.norm_eps)
        y, cm_prev = blocks.rwkv_channel_mix(p, h, cm_prev)
        return x + y, state, tm_prev, cm_prev

    def _hybrid_unit(self, p, x, caches=None, collect_kv=False,
                     attend=None):
        """One recurrentgemma unit over x (B, S, d) from the recurrent and
        conv states ``caches`` (zeros when None).  Local attention is
        ``attention_seq`` over the last ``cfg.local_window`` positions, or
        ``attend(p_attn, normed x)`` when given (decode).  Returns (x, the
        new states {h1, c1, h2, c2}, (roped K, V) of the attention input
        when ``collect_kv``, else None)."""
        cfg = self.cfg
        ln = p["ln"]
        st = caches or {}

        def norm(h, i):
            return rms_norm(h, ln[i].to(h.dtype), cfg.norm_eps)

        y, h1, c1 = blocks.rglru_seq(p["rg1"], norm(x, 0), cfg,
                                     st.get("h1"), st.get("c1"))
        x = x + y
        x = x + blocks.mlp_apply(p["mlp1"], norm(x, 1))
        y, h2, c2 = blocks.rglru_seq(p["rg2"], norm(x, 2), cfg,
                                     st.get("h2"), st.get("c2"))
        x = x + y
        x = x + blocks.mlp_apply(p["mlp2"], norm(x, 3))
        hn = norm(x, 4)
        kv = None
        if collect_kv:
            _, k, v = blocks._qkv(p["attn"], hn, cfg)
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
            kv = (rope(k, positions, cfg.rope_theta), v)
        if attend is None:
            x = x + blocks.attention_seq(p["attn"], hn, cfg,
                                         window=cfg.local_window)
        else:
            x = x + attend(p["attn"], hn)
        x = x + blocks.mlp_apply(p["mlp3"], norm(x, 5))
        return x, {"h1": h1, "c1": c1, "h2": h2, "c2": c2}, kv

    def _tail_layer(self, tp, x, h0=None, conv_state=None):
        """One RG-LRU tail layer; returns (x, hS, conv state)."""
        cfg = self.cfg
        y, h, c = blocks.rglru_seq(
            tp["rg"], rms_norm(x, tp["ln1"].to(x.dtype), cfg.norm_eps), cfg,
            h0, conv_state)
        x = x + y
        x = x + blocks.mlp_apply(
            tp["mlp"], rms_norm(x, tp["ln2"].to(x.dtype), cfg.norm_eps))
        return x, h, c

    def _backbone(self, params, x, enc=None):
        """Full-sequence trunk (loss), x: (B, S, d); ``enc`` is the audio
        encoder's output.  Returns (x, the sum of the layers' aux losses in
        layer order, 0-d f32; zero but for MoE)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        n = cfg.n_layers // 3 if cfg.family == "hybrid" else cfg.n_layers
        block = {"audio": self._cross_block, "ssm": self._ssm_block,
                 "hybrid": self._hybrid_unit}.get(cfg.family,
                                                   self._decoder_block)
        extra = (enc,) if cfg.family == "audio" else ()
        for p in unstack_layers(params["layers"], n):
            out = self._remat(block, p, x, *extra)
            x = out[0]
            if cfg.family in ("dense", "moe", "vlm") and out[1] is not None:
                aux = aux + out[1]
        if cfg.family == "hybrid":
            for tp in params.get("tail", []):
                x, _, _ = self._tail_layer(tp, x)
        x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
        return x, aux

    def _embed_inputs(self, params, batch):
        """Token embedding, after the projected patches for VLM; returns
        (x, labels, loss_mask), the last two None without
        ``batch["labels"]``.  VLM's labels and mask are 0 over the
        patches, so the loss counts the text positions only."""
        x = params["embed"][self._long(batch["tokens"])].to(self.dtype)
        if self.cfg.family == "vlm":
            patches = torch.as_tensor(batch["patch_embeds"],
                                      device=self.device).to(self.dtype)
            x = torch.cat([patches @ params["vision_proj"].to(self.dtype), x],
                          dim=1)
        if "labels" not in batch:
            return x, None, None
        labels = self._long(batch["labels"])
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=self.device)
        if self.cfg.family == "vlm":
            P = x.shape[1] - labels.shape[1]
            labels = torch.nn.functional.pad(labels, (P, 0))
            mask = torch.nn.functional.pad(mask, (P, 0))
        return x, labels, mask

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

    def loss(self, params, batch):
        """Mean next-token cross-entropy of ``batch`` ({"tokens", "labels"}
        of (B, S), audio's ``"frames"`` (B, F, d), VLM's ``"patch_embeds"``
        (B, P, 1024), whose positions the mean leaves out); returns (xent +
        0.01 * aux, {"xent", "aux"}) as 0-d f32 tensors, aux being the MoE
        layers' load-balance loss (zero for the other families)."""
        enc = (self._encode_audio(params, batch["frames"])
               if self.cfg.family == "audio" else None)
        x, labels, mask = self._embed_inputs(params, batch)
        x, aux = self._backbone(params, x, enc)
        xent = self._xent(params, x, labels, mask)
        return xent + 0.01 * aux, {"xent": xent, "aux": aux}

    @torch.no_grad()
    def prefill(self, params, batch):
        """Ingest whole prompts ``batch["tokens"]`` (B, S); returns
        (last-position logits (B, 1, V) f32, the cache :meth:`decode_step`
        reads).  Dense and MoE: {k, v} of (L, B, S, Hkv, hd) with K roped
        at positions 0..S-1.  VLM: the same over the P patches of
        ``batch["patch_embeds"]`` and the S tokens, (L, B, P + S, Hkv,
        hd).  Audio: the same, after encoding
        ``batch["frames"]`` (B, F, d), and each layer's ``cross_k`` /
        ``cross_v`` (L, B, F, Hkv, hd).  Hybrid: the states after position
        S-1, and K/V of the last W = min(S, local_window) positions in
        their ring slots (the :meth:`init_cache` layout at context S).
        Ssm: each layer's state after position S-1 and its mixes' last
        normed inputs."""
        cfg = self.cfg
        if cfg.family == "audio":
            return self._prefill_audio(params, batch)
        x, _, _ = self._embed_inputs(params, batch)
        if cfg.family == "hybrid":
            return self._prefill_hybrid(params, x)
        if cfg.family == "ssm":
            return self._prefill_ssm(params, x)
        B, S, _ = x.shape
        cache = self._empty_cache(torch.empty, B, S)
        positions = torch.arange(S, device=self.device)[None, :]
        for i in range(cfg.n_layers):
            pl = layer_params(params["layers"], i)
            # the reference recomputes the layer's K/V for the cache
            hn = rms_norm(x, pl["ln1"].to(x.dtype), cfg.norm_eps)
            _, k, v = blocks._qkv(pl["attn"], hn, cfg)
            cache["k"][i] = rope(k, positions, cfg.rope_theta)
            cache["v"][i] = v
            x, _ = self._decoder_block(pl, x)
        x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
        logits = x[:, -1:] @ params["lm_head"].to(x.dtype)
        return logits.float(), cache

    def _prefill_audio(self, params, batch):
        cfg = self.cfg
        enc = self._encode_audio(params, batch["frames"])
        x, _, _ = self._embed_inputs(params, batch)
        B, S, _ = x.shape
        cache = self._empty_cache(torch.empty, B, S)
        positions = torch.arange(S, device=self.device)[None, :]
        for i in range(cfg.n_layers):
            pl = layer_params(params["layers"], i)
            # the reference recomputes the layer's K/V for the cache
            hn = rms_norm(x, pl["ln1"].to(x.dtype), cfg.norm_eps)
            _, k, v = blocks._qkv(pl["attn"], hn, cfg)
            cache["k"][i] = rope(k, positions, cfg.rope_theta)
            cache["v"][i] = v
            x, cache["cross_k"][i], cache["cross_v"][i] = self._cross_block(
                pl, x, enc)
        x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
        logits = x[:, -1:] @ params["lm_head"].to(x.dtype)
        return logits.float(), cache

    def _prefill_ssm(self, params, x):
        cfg = self.cfg
        cache = self._empty_cache(torch.empty, x.shape[0], x.shape[1])
        for i in range(cfg.n_layers):
            x, cache["state"][i], cache["tm_prev"][i], cache["cm_prev"][i] = \
                self._ssm_block(layer_params(params["layers"], i), x)
        x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
        logits = x[:, -1:] @ params["lm_head"].to(x.dtype)
        return logits.float(), cache

    def _prefill_hybrid(self, params, x):
        cfg = self.cfg
        B, S, _ = x.shape
        W = min(S, cfg.local_window)
        # the ring slot of position p is p % W; the last W positions fill
        # every slot once, and slot s holds ring_pos[s]
        slots = torch.arange(W, device=self.device)
        ring_pos = S - 1 - ((S - 1 - slots) % W)
        cache = self._empty_cache(torch.empty, B, W)
        for i in range(cfg.n_layers // 3):
            x, st, (k, v) = self._hybrid_unit(
                layer_params(params["layers"], i), x, collect_kv=True)
            for key, val in st.items():
                cache[key][i] = val
            cache["k"][i] = k[:, ring_pos]
            cache["v"][i] = v[:, ring_pos]
        for j, tp in enumerate(params.get("tail", [])):
            x, cache["tail_h"][j], cache["tail_c"][j] = self._tail_layer(tp, x)
        x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
        logits = x[:, -1:] @ params["lm_head"].to(x.dtype)
        return logits.float(), cache

    # -------------------------------------------------------------- serving
    def _empty_cache(self, alloc, batch: int, context: int) -> dict:
        """The decode cache's leaves, made by ``alloc`` (torch.zeros or
        torch.empty); see :meth:`init_cache`."""
        cfg = self.cfg
        dt, dev = self.dtype, self.device
        if cfg.family == "ssm":
            L, d, hd = cfg.n_layers, cfg.d_model, cfg.rwkv_head_dim
            return {"state": alloc((L, batch, d // hd, hd, hd),
                                   dtype=torch.float32, device=dev),
                    "tm_prev": alloc((L, batch, d), dtype=dt, device=dev),
                    "cm_prev": alloc((L, batch, d), dtype=dt, device=dev)}
        if cfg.family != "hybrid":
            L, C = cfg.n_layers, context
        else:
            L, C = cfg.n_layers // 3, min(context, cfg.local_window)
        kv = (L, batch, C, cfg.n_kv_heads, cfg.head_dim_)
        c = {"k": alloc(kv, dtype=dt, device=dev),
             "v": alloc(kv, dtype=dt, device=dev)}
        if cfg.family == "audio":
            xkv = (L, batch, cfg.n_frames, cfg.n_kv_heads, cfg.head_dim_)
            c["cross_k"] = alloc(xkv, dtype=dt, device=dev)
            c["cross_v"] = alloc(xkv, dtype=dt, device=dev)
        if cfg.family != "hybrid":
            return c
        w = cfg.rglru_width
        for h, conv, n in (("h1", "c1", L), ("h2", "c2", L),
                           ("tail_h", "tail_c", cfg.n_layers % 3)):
            if n:
                c[h] = alloc((n, batch, w), dtype=torch.float32, device=dev)
                c[conv] = alloc((n, batch, 3, w), dtype=dt, device=dev)
        return c

    def init_cache(self, batch: int, context: int) -> dict:
        """Zeroed decode cache.  Dense, MoE and VLM: {k, v} of (L, batch,
        context, Hkv, hd); VLM's context holds the patches too.  Audio:
        those and {cross_k, cross_v} of (L, batch, n_frames, Hkv, hd), for
        a prefill's to be copied in.  Ssm:
        {state (L, batch, H, hd, hd) f32, tm_prev, cm_prev (L, batch, d)},
        whatever the context.  Hybrid: the unit states, K/V rings of (n_units,
        batch, min(context, local_window), Hkv, hd), and the tail's
        states."""
        return self._empty_cache(torch.zeros, batch, context)

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
        (``kv_gather``: ``"take"`` or the ``"cuda"`` kernel).

        MoE routes each chunk row on its own: capacity counts the row's c
        positions, its padded tail and dummy rows included, as in the
        reference."""
        cfg = self.cfg
        if cfg.family not in ("dense", "moe"):          # ssm too, as in the
            raise NotImplementedError(                  # reference
                f"chunked prefill serves the standard-KV families (dense, "
                f"moe), not {cfg.family!r}")
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
                krow, vrow = _gather_kv_rows(kc, vc, tbl, engine=kv_gather)
            a = chunk_cache_attention(q, krow, vrow, positions)
            x = x + a.reshape(P, c, -1) @ pl["attn"]["wo"].to(x.dtype)
            hn = rms_norm(x, pl["ln2"].to(x.dtype), cfg.norm_eps)
            x = x + self._ffn(pl, hn)[0]
        x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
        idx = torch.clamp(n_valid - 1, 0, c - 1)
        xl = x[torch.arange(P, device=self.device), idx]           # (P, d)
        logits = xl @ params["lm_head"].to(x.dtype)
        return logits.float(), cache

    def prefill_chunk(self, params, cache, tokens, slot, offset, n_valid):
        """Single-slot chunked prompt ingestion: the P = 1 case of
        :meth:`prefill_chunks` on the contiguous cache.  tokens: (1, c);
        slot / offset / n_valid: ints.  Returns ((1, V) f32 logits at the
        last valid position, the cache)."""
        return self.prefill_chunks(params, cache, tokens, [slot], [offset],
                                   [n_valid])

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, pos, block_table=None,
                    kv_gather: str = "take", decode_kernel: str = "dense"):
        """One token for the whole batch.  tokens: (B, 1); pos: an int or a
        (B,) per-row position vector (paged serving).  ``block_table``
        (dense and MoE) switches the KV leaves to the block pool and
        ``decode_kernel`` picks its attention route (see
        :func:`repro_torch.nn.blocks.attention_step`).  The hybrid's local
        attention writes slot pos % C of its ring and attends over the
        whole ring, which holds the window.  VLM embeds the token only; its
        ``pos`` counts the patches.  Audio attends, unroped, to
        every frame of the cross leaves, which it leaves as they are.  Ssm
        ignores ``pos``: each layer steps its state and mixes once.  Updates
        the cache IN PLACE; returns ((B, 1, V) f32 logits, the cache)."""
        cfg = self.cfg
        tokens = self._long(tokens)
        B = tokens.shape[0]
        x = params["embed"][tokens].to(self.dtype)                 # (B, 1, d)
        if block_table is not None and cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"block-paged decode serves the standard-KV families (dense, "
                f"moe), not {cfg.family!r}")
        if cfg.family == "ssm":
            for i in range(cfg.n_layers):
                x, cache["state"][i], cache["tm_prev"][i], \
                    cache["cm_prev"][i] = self._ssm_block(
                        layer_params(params["layers"], i), x,
                        cache["state"][i], cache["tm_prev"][i],
                        cache["cm_prev"][i])
            x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
            logits = x @ params["lm_head"].to(x.dtype)
            return logits.float(), cache
        if block_table is not None:
            block_table = self._long(block_table)
        if torch.is_tensor(pos) or np.ndim(pos):
            pos = self._long(pos).reshape(B)
            writes = blocks.kv_writes(cache["k"][0], pos, block_table)
        elif block_table is not None:
            raise ValueError("block-paged decode needs per-row pos")
        else:
            writes = None              # one shared int position: no lookup
        if cfg.family == "hybrid":
            x = self._decode_hybrid(params, cache, x, pos, writes)
        elif cfg.family == "audio":
            x = self._decode_audio(params, cache, x, pos, writes)
        else:
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
                x = x + self._ffn(pl, hn)[0]
        x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
        logits = x @ params["lm_head"].to(x.dtype)
        return logits.float(), cache

    def _decode_audio(self, params, cache, x, pos, writes):
        cfg = self.cfg
        for i in range(cfg.n_layers):
            pl = layer_params(params["layers"], i)
            kv = {"k": cache["k"][i], "v": cache["v"][i]}
            hn = rms_norm(x, pl["ln1"].to(x.dtype), cfg.norm_eps)
            x = x + blocks.attention_step(pl["attn"], hn, kv, pos, cfg,
                                          writes=writes)[0]
            hn = rms_norm(x, pl["ln_x"].to(x.dtype), cfg.norm_eps)
            x = x + blocks.cross_attention_step(
                pl["xattn"], hn, cache["cross_k"][i], cache["cross_v"][i],
                cfg)
            hn = rms_norm(x, pl["ln2"].to(x.dtype), cfg.norm_eps)
            x = x + blocks.mlp_apply(pl["mlp"], hn)
        return x

    def _decode_hybrid(self, params, cache, x, pos, writes):
        cfg = self.cfg
        for i in range(cfg.n_layers // 3):
            kv = {"k": cache["k"][i], "v": cache["v"][i]}

            def attend(p_attn, hn):
                return blocks.attention_step(p_attn, hn, kv, pos, cfg,
                                             writes=writes)[0]
            x, st, _ = self._hybrid_unit(
                layer_params(params["layers"], i), x,
                {key: cache[key][i] for key in ("h1", "c1", "h2", "c2")},
                attend=attend)
            for key, val in st.items():
                cache[key][i] = val
        for j, tp in enumerate(params.get("tail", [])):
            x, cache["tail_h"][j], cache["tail_c"][j] = self._tail_layer(
                tp, x, cache["tail_h"][j], cache["tail_c"][j])
        return x
