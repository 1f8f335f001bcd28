"""Paged-slot serving engine: chunked prefill, admission queue, slot reuse
(counterpart of ``repro/runtime/serve.py``).

``ServeEngine`` serves the standard-KV families, dense and MoE, with:

* a slot-based paged KV cache (:class:`repro_torch.runtime.kvcache.
  PagedKVCache`): fixed ``max_batch`` x ``max_context`` capacity, per-slot
  position counters, slot reuse the moment a request finishes; with
  ``kv_block_size > 0`` the cache is a pool of fixed-size blocks with
  per-slot block tables;
* decoupled prefill / decode dispatches with batched chunked prefill: up
  to ``prefill_batch`` chunks from different prefilling slots per engine
  step, in one fixed-shape (P, chunk) dispatch;
* a request queue with admission control (reject or tail-truncate prompts
  beyond ``max_context``, per-request queue deadlines, FIFO by arrival)
  and per-request latency stats;
* a counted sampler: at ``temperature > 0`` each row's Gumbel noise comes
  from a generator seeded by (seed, rid, token index), so a request's
  stream does not depend on the batch it rides in;
* ``kv_gather`` (``"take"`` or the ``"cuda"`` gather kernel) and
  ``decode_kernel`` (``"dense"``, ``"reference"`` or the ``"fused"``
  paged-attention kernel) for the block-paged reads; ``"auto"`` consults
  the measured-dispatch cache (``repro_torch.tune``);
* in-place cache updates: both dispatches write the KV tensors in place.

With ``quantized=True`` the matmul weights stay resident as int8-PoT and
are dequantized inside each dispatch, and ``serving_sheet`` holds the
``serving_ledger`` of the served bits.

``ReferenceEngine`` is the reference's parity oracle: a fixed decode batch,
whole-batch left-padded prefill through ``Model.prefill`` (and so through
the flash-attention kernel on the card), the prefill cache padded to the
serving context, and batch refresh only at prefill boundaries.

Both engines run on the card unless the caller passes ``device="cpu"``;
with no card visible they raise.  Not ported yet: data/tensor-parallel
decode.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.nn.model import Model, resolve_device
from repro_torch.nn.types import ArchConfig
from repro_torch.quant import serving_ledger, serving_quant
from repro_torch.runtime import kvcache
from repro_torch.runtime.kvcache import (ADMIT_REJECT, ADMIT_TRUNCATE,
                                         PagedKVCache)

__all__ = ["ServeEngine", "ReferenceEngine", "Request", "summarize",
           "percentile"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 32
    deadline_s: float | None = None   # max queue wait before expiry
    # streaming callback: on_token(rid, step, token) fires the moment each
    # generated token lands (step = 0-based index into ``out_tokens``)
    on_token: object = None
    out_tokens: list = field(default_factory=list)
    done: bool = False
    # lifecycle: new -> queued -> running -> done | rejected | expired
    status: str = "new"
    truncated: bool = False
    arrival_s: float = 0.0
    stats: dict = field(default_factory=dict)


def percentile(xs, p) -> float:
    """The sorted value at index ``round(p / 100 * (n - 1))`` (0.0 for no
    values)."""
    xs = sorted(xs)
    if not xs:
        return 0.0
    return xs[min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))]


def summarize(requests, engine=None) -> dict:
    """p50/p99 latency + throughput over a served request list.

    Reads the per-request ``stats`` the engine fills in: total_s (arrival
    -> done), first_token_s (arrival -> first sampled token), and
    decode_tokens/decode_s.  Rejected/expired requests count in their own
    buckets and are excluded from the percentiles.  ``decode_tok_s``
    divides by the engine's aggregate batched-decode wall time (0.0
    without an engine)."""
    done = [r for r in requests if r.status == "done"]

    def pct(key, p):
        return percentile([r.stats[key] for r in done if key in r.stats], p)

    dec_tok = sum(r.stats.get("decode_tokens", 0) for r in done)
    dec_s = engine.stats.get("decode_s", 0.0) if engine is not None else 0.0
    return {
        "n": len(requests), "done": len(done),
        "rejected": sum(r.status == "rejected" for r in requests),
        "expired": sum(r.status == "expired" for r in requests),
        "truncated": sum(r.truncated for r in requests),
        "p50_total_s": pct("total_s", 50), "p99_total_s": pct("total_s", 99),
        "p50_first_token_s": pct("first_token_s", 50),
        "p99_first_token_s": pct("first_token_s", 99),
        "decode_tokens": dec_tok,
        "decode_tok_s": dec_tok / dec_s if dec_s > 0 else 0.0,
    }


@dataclass
class _Slot:
    """Host-side state of one cache slot while a request runs in it."""
    req: Request
    n_prefilled: int = 0          # prompt tokens already ingested
    phase: str = "prefill"        # prefill -> decode
    assigned_s: float = 0.0
    seq: int = 0                  # assignment sequence (prefill FIFO order)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    if torch.is_tensor(tree):
        return tree.to(device)
    return tree


def _sync(device):
    """Wait for the device, so a dispatch's wall time is what the stats
    read."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _emit(r):
    """Fire the streaming callback for the token just appended."""
    if r.on_token is not None:
        r.on_token(r.rid, len(r.out_tokens) - 1, r.out_tokens[-1])


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _row_seed(seed: int, rid: int, step: int) -> int:
    """A generator seed that depends on (seed, rid, step) only."""
    h = 0x243F6A8885A308D3
    for v in (seed, rid, step):
        h = ((h ^ (int(v) & 0xFFFFFFFFFFFFFFFF)) * 0x100000001B3) \
            & 0xFFFFFFFFFFFFFFFF
    return h & 0x7FFFFFFFFFFFFFFF


def _auto_decode_kernel(cfg: ArchConfig, device, max_batch: int,
                        max_context: int, kv_block_size: int) -> str:
    """``decode_kernel="auto"``: the measured-dispatch cache's winner for
    this (platform, batch x context x block) neighbourhood, else the static
    "dense" rule.  Consult-only, as in the reference: nothing is measured
    here.  Without a block pool only the gather+dense route exists.  Fused
    and dense are candidates together only in f32, where the tests hold
    their greedy tokens equal; in bf16 the two round the softmax at other
    places and agree only within a tolerance, so there "dense" is the one
    candidate and no cache entry can move a bf16 engine's tokens."""
    if not kv_block_size:
        return "dense"
    from repro_torch import tune
    cands = ("dense", "fused") if cfg.dtype == "float32" else ("dense",)
    return tune.decide("decode_kernel",
                       shape=(max_batch, max_context, kv_block_size),
                       dtype=str(cfg.dtype), candidates=cands,
                       heuristic="dense", plat=device.type)


class ServeEngine:
    """Slot-paged serving engine for the standard-KV families (dense,
    moe)."""

    def __init__(self, cfg: ArchConfig, params, *, max_batch: int = 8,
                 max_context: int = 512, eos_id: int = 0,
                 quantized: bool = False, quant_bits=8,
                 temperature: float = 0.0, seed: int = 0,
                 prefill_chunk: int = 64, prefill_batch: int = 1,
                 kv_block_size: int = 0, kv_gather: str = "take",
                 decode_kernel: str = "dense", admission: str = "reject",
                 device="cuda", clock=time.monotonic):
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"paged serving supports the standard-KV families (dense, "
                f"moe), not {cfg.family!r}; use ReferenceEngine")
        if kv_gather not in ("take", "cuda"):
            raise ValueError(f"unknown kv_gather {kv_gather!r}")
        self.device = resolve_device(device)
        if decode_kernel == "auto":
            decode_kernel = _auto_decode_kernel(cfg, self.device, max_batch,
                                                max_context, kv_block_size)
        if decode_kernel not in ("dense", "reference", "fused"):
            raise ValueError(f"unknown decode_kernel {decode_kernel!r}")
        if decode_kernel != "dense" and not kv_block_size:
            raise ValueError(
                "decode_kernel='reference'/'fused' read the block pool "
                "directly; they need kv_block_size > 0")
        self.cfg = cfg
        self.model = Model(cfg, device=self.device)
        self.max_batch = max_batch
        self.max_context = max_context
        self.eos_id = eos_id
        self.temperature = temperature
        self.seed = seed
        self.admission = admission
        self.prefill_chunk = min(prefill_chunk, max_context)
        self.prefill_batch = max(1, min(prefill_batch, max_batch))
        self.kv_block_size = kv_block_size
        self.kv_gather = kv_gather
        self.decode_kernel = decode_kernel
        self.clock = clock
        params = _to_device(params, self.device)
        if quantized:
            # weights stay resident as int8 + PoT exponents; dequantization
            # (exact: PoT scales) happens inside each dispatch
            self.quant_tree, deq, self.quant_bytes = serving_quant(
                params, bits=quant_bits, dtype=self.model.dtype)
            self.params = self.quant_tree
            self.serving_sheet = serving_ledger(
                params, bits=quant_bits,
                act_itemsize=float(_itemsize(self.model.dtype)))
        else:
            self.params = params
            self.quant_tree = None
            self.quant_bytes = None
            self.serving_sheet = None
            deq = lambda t: t                                   # noqa: E731
        self._deq = deq
        self.cache = PagedKVCache(self.model, max_batch, max_context,
                                  block_size=kv_block_size)
        # bytes one logical cache row (K + V, every layer) occupies --
        # priced per dispatch by _decode_kv_bytes into stats["kv_bytes_read"]
        itemsize = self.cache.data["k"].element_size()
        self._kv_row_bytes = (cfg.n_layers * cfg.n_kv_heads
                              * cfg.head_dim_ * 2 * itemsize)
        self.queue: deque = deque()        # FIFO admitted requests
        self.slots: dict = {}              # slot id -> _Slot
        self.events: list = []             # (step, action, rid, slot)
        self._step_idx = 0
        self._seq = 0
        self.stats = {"prefill_tokens": 0, "decode_tokens": 0,
                      "prefill_s": 0.0, "decode_s": 0.0,
                      "prefill_chunks": 0, "prefill_dispatches": 0,
                      "decode_steps": 0, "steps": 0,
                      "admitted": 0, "rejected": 0, "truncated": 0,
                      "expired": 0, "finished": 0, "kv_bytes_read": 0.0}

    # ------------------------------------------------------------ dispatches
    def _table(self):
        return torch.as_tensor(self.cache.block_table, device=self.device)

    def _prefill(self, toks, slots, offs, nval):
        tbl = self._table() if self.kv_block_size else None
        return self.model.prefill_chunks(
            self._deq(self.params), self.cache.data, toks, slots, offs, nval,
            block_table=tbl, kv_gather=self.kv_gather)

    def _decode(self, toks, pos):
        tbl = self._table() if self.kv_block_size else None
        return self.model.decode_step(
            self._deq(self.params), self.cache.data, toks, pos,
            block_table=tbl, kv_gather=self.kv_gather,
            decode_kernel=self.decode_kernel)


    def _sample(self, logits: torch.Tensor, rids, steps) -> np.ndarray:
        """logits: (B, V) f32; rids/steps: per-row (B,) ints.  Greedy at
        temperature 0; else one Gumbel-argmax per row, its noise from a
        generator seeded by (seed, rid, step)."""
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        out = np.zeros(len(rids), np.int64)
        for i, (rid, step) in enumerate(zip(rids, steps)):
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(_row_seed(self.seed, rid, step))
            u = torch.rand(logits.shape[-1], generator=gen,
                           device=logits.device)
            u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
            g = -torch.log(-torch.log(u))
            out[i] = int(torch.argmax(logits[i] / self.temperature + g))
        return out

    # ------------------------------------------------------------- frontend
    def _now(self, now):
        return self.clock() if now is None else now

    def submit(self, req: Request, now=None) -> str:
        """Admission: reject/truncate over-long prompts, then enqueue FIFO."""
        now = self._now(now)
        verdict, eff = kvcache.admit(len(req.prompt), self.max_context,
                                     self.admission)
        if verdict == ADMIT_REJECT:
            req.status = "rejected"
            req.done = True
            self.stats["rejected"] += 1
            self.events.append((self._step_idx, "reject", req.rid, None))
            return req.status
        if verdict == ADMIT_TRUNCATE:
            req.prompt = np.asarray(req.prompt)[-eff:]   # keep the tail
            req.truncated = True
            self.stats["truncated"] += 1
            self.events.append((self._step_idx, "truncate", req.rid, None))
        # decode writes reach position len(prompt) + max_new - 2; cap so the
        # slot never wraps
        req.stats["max_new_eff"] = min(
            req.max_new_tokens, self.max_context + 1 - len(req.prompt))
        req.status = "queued"
        req.arrival_s = now
        self.stats["admitted"] += 1
        self.queue.append(req)
        self.events.append((self._step_idx, "admit", req.rid, None))
        return req.status

    # ------------------------------------------------------------ main loop
    def step(self, now=None) -> list:
        """One scheduling iteration: expire -> refill slots -> one batched
        prefill dispatch (up to ``prefill_batch`` chunks) -> one decode step
        over every decoding slot.  Returns the requests finished this step.
        ``now`` injects the caller's timebase for every timestamp."""
        t = self._now(now)
        self._step_idx += 1
        self.stats["steps"] += 1
        self._expire(t)
        self._assign(t)
        self._prefill_step(now)
        return self._decode_step(now)

    def run(self, requests: list) -> list:
        """Serve a list of Requests to completion; returns them filled."""
        for r in requests:
            self.submit(r)
        while self.queue or self.slots:
            self.step()
        return requests

    def _expire(self, now):
        meta = [(r.rid, r.arrival_s,
                 None if r.deadline_s is None else r.arrival_s + r.deadline_s)
                for r in self.queue]
        expired, _ = kvcache.expire(meta, now)
        if not expired:
            return
        dead = set(expired)
        for r in list(self.queue):
            if r.rid in dead:
                self.queue.remove(r)
                r.status = "expired"
                r.done = True
                r.stats["queue_s"] = now - r.arrival_s
                self.stats["expired"] += 1
                self.events.append((self._step_idx, "expire", r.rid, None))

    def _assign(self, now):
        while self.queue and self.cache.n_free:
            r = self.queue.popleft()
            slot = self.cache.alloc(r.rid)
            r.status = "running"
            r.stats["queue_s"] = now - r.arrival_s
            self.slots[slot] = _Slot(req=r, assigned_s=now, seq=self._seq)
            self._seq += 1
            self.events.append((self._step_idx, "assign", r.rid, slot))


    def _prefill_step(self, now):
        """Ingest up to ``prefill_batch`` chunks from different prefilling
        slots in one fixed-shape (P, chunk) dispatch, oldest assignment
        first.  Unused rows ride along as dummies at offset = max_context:
        every one of their writes is left out and their logits ignored."""
        pending = sorted((st.seq, slot) for slot, st in self.slots.items()
                         if st.phase == "prefill")
        if not pending:
            return
        picked = [slot for _, slot in pending[:self.prefill_batch]]
        P, chunk = self.prefill_batch, self.prefill_chunk
        toks = np.zeros((P, chunk), np.int32)
        slots = np.zeros(P, np.int32)
        offs = np.full(P, self.max_context, np.int32)   # dummies: all-drop
        nval = np.ones(P, np.int32)
        ns = []
        for i, slot in enumerate(picked):
            st = self.slots[slot]
            r = st.req
            n = min(chunk, len(r.prompt) - st.n_prefilled)
            toks[i, :n] = r.prompt[st.n_prefilled:st.n_prefilled + n]
            slots[i], offs[i], nval[i] = slot, st.n_prefilled, n
            ns.append(n)
            if self.kv_block_size:
                self.cache.ensure(slot, st.n_prefilled + n)
        t0 = time.time()
        logits, self.cache.data = self._prefill(toks, slots, offs, nval)
        _sync(self.device)
        dt = time.time() - t0
        self.stats["prefill_s"] += dt
        self.stats["prefill_tokens"] += int(sum(ns))
        self.stats["prefill_chunks"] += len(picked)
        self.stats["prefill_dispatches"] += 1
        done_rows = []
        for i, slot in enumerate(picked):
            st = self.slots[slot]
            st.req.stats["prefill_s"] = \
                st.req.stats.get("prefill_s", 0.0) + dt
            st.n_prefilled += ns[i]
            self.cache.lengths[slot] = st.n_prefilled
            if st.n_prefilled >= len(st.req.prompt):
                done_rows.append((i, slot))
        if not done_rows:
            return
        # prompts fully ingested: their first tokens come from the rows'
        # last-valid-position logits (token index 0; a first-token EOS is
        # deliberately not checked, as in the reference)
        rows = [i for i, _ in done_rows]
        rids = [self.slots[s].req.rid for _, s in done_rows]
        nxt = self._sample(logits[rows], rids, [0] * len(rows))
        t_first = self._now(now)
        for j, (i, slot) in enumerate(done_rows):
            st = self.slots[slot]
            r = st.req
            r.out_tokens.append(int(nxt[j]))
            _emit(r)
            r.stats["first_token_s"] = t_first - r.arrival_s
            st.phase = "decode"
            if len(r.out_tokens) >= r.stats["max_new_eff"]:
                self._finish(slot, t_first)

    def _decode_kv_bytes(self, pos) -> float:
        """Analytic KV bytes one decode dispatch reads for its attention,
        summed over every slot row in the fixed-shape batch (idle rows ride
        along and their cache is read).  Host-side pricing, not a
        measurement:

        * contiguous slab — the dense masked pass streams every slot's full
          ``max_context`` row once;
        * block pool, ``decode_kernel="dense"`` — gather reads the whole
          table's blocks, writes the contiguous copy, and the dense pass
          reads it back: 3x full-row traffic;
        * ``"reference"`` — one pass over every table entry;
        * ``"fused"`` — one pass over just ``ceil(len/bs)`` blocks per slot.
        """
        C = self.max_context
        clen = np.minimum(np.asarray(pos) + 1, C)
        if not self.kv_block_size:
            rows = C * clen.size
        elif self.decode_kernel == "dense":
            rows = 3 * C * clen.size
        elif self.decode_kernel == "reference":
            rows = C * clen.size
        else:                                  # fused
            bs = self.kv_block_size
            rows = int(np.sum(-(-clen // bs) * bs))
        return float(rows) * self._kv_row_bytes

    def _decode_step(self, now):
        """One decode token for every decoding slot in a single fixed-shape
        dispatch.  Idle/prefilling slots ride along as dummy rows: their
        write position is their own next-write index, so the garbage they
        deposit is always overwritten before the slot length reaches it."""
        active = [slot for slot, st in self.slots.items()
                  if st.phase == "decode"]
        if not active:
            return []
        B = self.max_batch
        toks = np.zeros((B, 1), np.int32)
        pos = np.minimum(self.cache.lengths.copy(), self.max_context - 1)
        rids = np.zeros(B, np.int64)
        steps = np.zeros(B, np.int64)
        for slot in active:
            r = self.slots[slot].req
            toks[slot, 0] = r.out_tokens[-1]
            pos[slot] = self.cache.lengths[slot]
            rids[slot] = r.rid
            steps[slot] = len(r.out_tokens)
            if self.kv_block_size:
                # the fed token's KV lands at position lengths[slot]
                self.cache.ensure(slot, int(self.cache.lengths[slot]) + 1)
        t0 = time.time()
        lg, self.cache.data = self._decode(toks, pos.astype(np.int64))
        _sync(self.device)
        dt = time.time() - t0
        self.stats["decode_s"] += dt
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += len(active)
        self.stats["kv_bytes_read"] += self._decode_kv_bytes(pos)
        nxt = self._sample(lg[:, 0], rids, steps)
        t_done = self._now(now)
        finished = []
        for slot in active:
            st = self.slots[slot]
            r = st.req
            self.cache.lengths[slot] += 1     # the fed token's KV was written
            tok = int(nxt[slot])
            r.out_tokens.append(tok)
            _emit(r)
            r.stats["decode_tokens"] = r.stats.get("decode_tokens", 0) + 1
            r.stats["decode_s"] = r.stats.get("decode_s", 0.0) + dt
            if tok == self.eos_id or \
                    len(r.out_tokens) >= r.stats["max_new_eff"]:
                finished.append(r)
                self._finish(slot, t_done)
        return finished

    def _finish(self, slot, now):
        st = self.slots.pop(slot)
        r = st.req
        r.done = True
        r.status = "done"
        r.stats["total_s"] = now - r.arrival_s
        dec_s = r.stats.get("decode_s", 0.0)
        r.stats["decode_tok_s"] = (r.stats.get("decode_tokens", 0) / dec_s
                                   if dec_s > 0 else 0.0)
        self.cache.release(slot)
        self.stats["finished"] += 1
        self.events.append((self._step_idx, "release", r.rid, slot))


class ReferenceEngine:
    """The reference's continuous-batching-lite engine, kept as the parity
    oracle and the only engine of the ssm (RWKV6) and hybrid families,
    whose caches hold recurrent states: fixed decode batch,
    whole-batch left-padded prefill (``Model.prefill``), ``_pad_kv``
    re-padding the K/V leaves to ``max_context``, batch refresh only at
    prefill boundaries.  Prompts beyond ``max_context`` are
    rejected or tail-truncated at enqueue (``admission``).

    Prompts of a batch are left-padded with token 0 and the padding is not
    masked, as in the reference: a prompt shorter than its batch's longest
    attends to the padding.  Prefill gets ``{"tokens"}`` only, as in the
    reference, so the audio family, which needs ``"frames"``, and the VLM
    family, which needs ``"patch_embeds"``, fail with ``KeyError``.
    Decode runs on the contiguous cache with one shared position for the
    batch (``Model.decode_step`` with an int)."""

    def __init__(self, cfg: ArchConfig, params, *, max_batch: int = 8,
                 max_context: int = 512, eos_id: int = 0,
                 quantized: bool = False, quant_bits=8,
                 temperature: float = 0.0, seed: int = 0,
                 admission: str = "reject", device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = Model(cfg, device=self.device)
        self.max_batch = max_batch
        self.max_context = max_context
        self.eos_id = eos_id
        self.temperature = temperature
        self.admission = admission
        self.rng = np.random.default_rng(seed)
        self.serving_sheet = None
        params = _to_device(params, self.device)
        if quantized:
            self.quant_tree, deq, _ = serving_quant(
                params, bits=quant_bits, dtype=self.model.dtype)
            self.serving_sheet = serving_ledger(
                params, bits=quant_bits,
                act_itemsize=float(_itemsize(self.model.dtype)))
            self.params = self.quant_tree
        else:
            self.params = params
            self.quant_tree = None
            deq = lambda t: t                                   # noqa: E731
        self._deq = deq
        self.stats = {"prefill_tokens": 0, "decode_tokens": 0,
                      "prefill_s": 0.0, "decode_s": 0.0, "rejected": 0,
                      "truncated": 0}

    def _sample(self, logits: np.ndarray) -> np.ndarray:
        if self.temperature <= 0:
            return np.argmax(logits, axis=-1)
        z = logits / self.temperature
        z = z - z.max(-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(-1, keepdims=True)
        return np.array([self.rng.choice(p.shape[-1], p=pi) for pi in p])

    def run(self, requests: list) -> list:
        """Serve a list of Requests to completion; returns them filled."""
        queue = []
        for r in requests:
            verdict, eff = kvcache.admit(len(r.prompt), self.max_context,
                                         self.admission)
            if verdict == ADMIT_REJECT:
                r.status, r.done = "rejected", True
                self.stats["rejected"] += 1
                continue
            if verdict == ADMIT_TRUNCATE:
                r.prompt = np.asarray(r.prompt)[-eff:]
                r.truncated = True
                self.stats["truncated"] += 1
            queue.append(r)
        while queue:
            batch = queue[:self.max_batch]
            queue = queue[self.max_batch:]
            self._serve_batch(batch)
        return requests

    def _serve_batch(self, batch: list):
        B = len(batch)
        S = max(len(r.prompt) for r in batch)
        toks = np.zeros((B, S), np.int32)
        for i, r in enumerate(batch):
            toks[i, S - len(r.prompt):] = r.prompt     # left-pad
        t0 = time.time()
        logits, cache = self.model.prefill(self._deq(self.params),
                                           {"tokens": toks})
        _sync(self.device)
        self.stats["prefill_s"] += time.time() - t0
        self.stats["prefill_tokens"] += int(B * S)
        # embed the prefill K/V into the serving context: only the "k"/"v"
        # leaves grow; recurrent and conv states (the ssm's state, tm_prev
        # and cm_prev among them) are fixed-size and pass through.  The hybrid's K/V is a ring of min(S, local_window)
        # slots, so padding it, as the reference does, misplaces positions
        # once a sequence passes the window with max_context > window.
        cache = {k: (self._pad_kv(v) if k in ("k", "v") else v)
                 for k, v in cache.items()}
        last = self._sample(logits[:, -1].cpu().numpy())
        for i, r in enumerate(batch):
            r.out_tokens.append(int(last[i]))
            _emit(r)
        max_new = max(min(r.max_new_tokens, self.max_context + 1 - S)
                      for r in batch)
        t0 = time.time()
        for t in range(1, max_new):
            lg, cache = self.model.decode_step(
                self._deq(self.params), cache, last[:, None], S + t - 1)
            last = self._sample(lg[:, 0].cpu().numpy())
            self.stats["decode_tokens"] += B
            for i, r in enumerate(batch):
                if not r.done and len(r.out_tokens) < r.max_new_tokens:
                    tok = int(last[i])
                    r.out_tokens.append(tok)
                    _emit(r)
                    if tok == self.eos_id:
                        r.done = True
            if all(r.done or len(r.out_tokens) >= r.max_new_tokens
                   for r in batch):
                break
        self.stats["decode_s"] += time.time() - t0
        for r in batch:
            r.done = True
            r.status = "done"

    def _pad_kv(self, leaf):
        """Grow a prefill KV cache (L, B, S, H, D) to the serving context."""
        if leaf.shape[2] < self.max_context:
            return torch.nn.functional.pad(
                leaf, (0, 0, 0, 0, 0, self.max_context - leaf.shape[2]))
        return leaf
