"""Slot-paged KV cache + the pure serving scheduler (DESIGN.md 13).

A copy of ``repro/runtime/kvcache.py``: pure host code, identical
decisions.  Two halves, deliberately separated so the scheduling policy is
testable without a model:

* :class:`PagedKVCache` — a fixed-capacity pool of ``n_slots`` cache rows of
  ``max_context`` positions each, holding the model's decode cache dict
  (leaves shaped ``(L, n_slots, max_context, ...)``).  Slots are allocated to
  requests at admission and reused the moment a request finishes — no
  whole-batch re-padding, ever.  Per-slot position counters live host-side
  (``lengths``); the device tensors are only ever updated in place by the
  prefill-chunk / decode dispatches.

* Pure scheduler functions — :func:`admit`, :func:`assign_slots`,
  :func:`expire` — and :func:`simulate`, a host-side oracle that replays an
  abstract event stream (arrivals, finishes) through exactly the same
  FIFO + deadline + lowest-free-slot policy the engine uses.  The serving
  tests property-check the oracle (no slot double-booking, no starvation,
  deadline ordering) and then assert the live engine's event log matches the
  oracle's decisions on the same stream.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ADMIT_OK", "ADMIT_TRUNCATE", "ADMIT_REJECT", "admit",
           "assign_slots", "expire", "simulate", "PagedKVCache",
           "alloc_blocks", "free_blocks", "blocks_needed"]

ADMIT_OK = "ok"
ADMIT_TRUNCATE = "truncate"
ADMIT_REJECT = "reject"


def admit(prompt_len: int, max_context: int, policy: str = "reject"):
    """Admission control for one prompt. Returns (verdict, effective_len).

    A prompt must leave at least one cache position free for the decode
    write, so the admissible prompt length is ``max_context - 1``.  Longer
    prompts are rejected (``policy="reject"``) or truncated to their TAIL
    (``policy="truncate"`` — the most recent context is what conditions
    generation).  This is the fix for the seed engine's overflow: ``_pad_kv``
    assumed S <= max_context and longer prompts silently corrupted the cache.
    """
    limit = max_context - 1
    if prompt_len <= limit:
        return ADMIT_OK, prompt_len
    if policy == "truncate":
        return ADMIT_TRUNCATE, limit
    if policy == "reject":
        return ADMIT_REJECT, 0
    raise ValueError(f"unknown admission policy {policy!r}")


def assign_slots(queue, free_slots):
    """FIFO slot assignment: i-th queued request -> i-th lowest free slot.

    ``queue`` is an ordered sequence of request ids (arrival order);
    ``free_slots`` any iterable of free slot ids.  Returns [(rid, slot)] for
    as many requests as there are slots — the head of the queue is never
    skipped, which is what makes the policy starvation-free.
    """
    return list(zip(queue, sorted(free_slots)))


def expire(queue_meta, now):
    """Deadline pass over queued requests.

    ``queue_meta``: ordered [(rid, arrival_t, deadline_t-or-None)];
    ``now``: current time.  Returns (expired_rids, remaining_meta): a queued
    request expires when ``now >= deadline_t``.  Expirations are reported in
    arrival order (the queue's order), so earlier-arrived requests with
    lapsed deadlines always expire first.
    """
    expired, remaining = [], []
    for rid, arrival, deadline in queue_meta:
        if deadline is not None and now >= deadline:
            expired.append(rid)
        else:
            remaining.append((rid, arrival, deadline))
    return expired, remaining


def blocks_needed(length: int, block_size: int) -> int:
    """Blocks covering ``length`` positions (ceil division; 0 for 0)."""
    return -(-length // block_size)


def alloc_blocks(free, n: int):
    """Pure block grant: take the ``n`` lowest-numbered free blocks.

    ``free``: iterable of free physical block ids.  Returns
    ``(granted, remaining)`` (both sorted lists).  Raises ``RuntimeError``
    when the pool cannot cover the request — allocation failure is an
    explicit error, never a silent partial grant.
    """
    free = sorted(free)
    if n > len(free):
        raise RuntimeError(
            f"KV block pool exhausted: need {n}, have {len(free)}")
    return free[:n], free[n:]


def free_blocks(free, returned):
    """Pure block release: merge ``returned`` back into the free pool.

    Asserts no block is returned twice (or while still free) — the
    double-booking guard mirrored by the engine-vs-oracle fuzz.
    """
    free = sorted(free)
    returned = list(returned)
    assert len(set(returned)) == len(returned), "block returned twice"
    assert not set(returned) & set(free), "released block already free"
    return sorted(free + returned)


def simulate(arrivals, finishes, n_slots: int, *, deadlines=None,
             horizon: int | None = None, n_blocks: int | None = None,
             blocks_of=None):
    """Host-side scheduler oracle: abstract events in, decision log out.

    ``arrivals``: [(t, rid)] (t integer step of submission, pre-admission
    filtering is the caller's problem — feed only admitted requests);
    ``finishes``: {rid: t} the step each running request releases its slot;
    ``deadlines``: {rid: absolute expiry step} for queued-timeout requests.
    Replays the engine's per-step order — expire, assign, then releases — and
    returns [(t, action, rid, slot)] with actions "assign" / "expire" /
    "release" (slot is None for "expire").  A request with no finish entry
    holds its slot forever (the starvation probe).

    ``n_blocks`` + ``blocks_of`` ({rid: worst-case KV blocks}) turn on
    BLOCK accounting: an assignment additionally reserves the request's
    blocks from a pool of ``n_blocks``, released with the slot.  When the
    head of the queue cannot get its blocks, assignment STOPS for the step —
    the head is never skipped, so the policy stays starvation-free even
    under block pressure.  (The live engine sizes its pool to
    n_slots * ceil(max_context / block_size), which can never run short, so
    its decisions coincide with the slot-only oracle; the scarce-pool mode
    exists for the scheduler property tests.)
    """
    deadlines = deadlines or {}
    blocks_of = blocks_of or {}
    arrivals = sorted(arrivals)
    if horizon is None:
        # deadlines count toward the horizon too: a queued request whose
        # deadline lapses after the last arrival/finish must still get its
        # "expire" event logged
        horizon = int(max([t for t, _ in arrivals] +
                          list(finishes.values()) +
                          list(deadlines.values()) + [0])) + 1
    queue: list = []          # [(rid, arrival, deadline)]
    free = list(range(n_slots))
    free_blk = list(range(n_blocks)) if n_blocks is not None else None
    blk_of: dict = {}         # rid -> granted block ids
    slot_of: dict = {}
    log = []
    ai = 0
    for t in range(horizon + 1):
        while ai < len(arrivals) and arrivals[ai][0] <= t:
            rid = arrivals[ai][1]
            queue.append((rid, arrivals[ai][0], deadlines.get(rid)))
            ai += 1
        expired, queue = expire(queue, t)
        for rid in expired:
            log.append((t, "expire", rid, None))
        for rid, slot in assign_slots([r for r, _, _ in queue], free):
            if free_blk is not None:
                need = blocks_of.get(rid, 0)
                if need > len(free_blk):
                    break     # head-of-queue waits; never skipped
                blk_of[rid], free_blk = alloc_blocks(free_blk, need)
            assert slot not in slot_of.values(), "double-booked slot!"
            slot_of[rid] = slot
            free.remove(slot)
            queue = [q for q in queue if q[0] != rid]
            log.append((t, "assign", rid, slot))
        for rid, tf in finishes.items():
            if tf == t and rid in slot_of:
                slot = slot_of.pop(rid)
                free.append(slot)
                if free_blk is not None:
                    free_blk = free_blocks(free_blk, blk_of.pop(rid, []))
                log.append((t, "release", rid, slot))
    return log


class PagedKVCache:
    """Fixed-capacity slot pool around a model decode-cache dict.

    CONTIGUOUS mode (``block_size=0``, the default): the device tensors
    (``.data``) are built once via ``model.init_cache`` with batch =
    ``n_slots`` and context = ``max_context`` and thereafter only rewritten
    in place by the serving dispatches — allocation and release are pure
    host-side bookkeeping (a slot's stale contents are never read: every
    read is masked by the slot's length, and every position is rewritten in
    place before the length crosses it).

    BLOCK-PAGED mode (``block_size > 0``): the dict holds a POOL of
    ``n_blocks = n_slots * (max_context // block_size)`` fixed-size blocks
    (leaves ``(L, n_blocks, block_size, ...)``) and each slot owns a row of
    ``block_table`` — an int32 (n_slots, blocks_per_slot) map from logical
    block index to physical block id.  Unallocated entries hold the
    OUT-OF-RANGE-HIGH sentinel ``n_blocks`` (NEVER -1: negative indices
    WRAP in torch indexing; a write to the sentinel is left out by the
    model, and reads clamp it and mask what they read).  Blocks are granted
    lazily by :meth:`ensure` as a slot's length grows and returned by
    :meth:`release`; the pool is sized so a full engine can never run
    short, which keeps the scheduler's decisions identical to the
    contiguous mode's (allocation failure is still a clean error —
    exercised by the unit tests with hand-shrunk pools).
    """

    def __init__(self, model, n_slots: int, max_context: int,
                 block_size: int = 0):
        self.n_slots = n_slots
        self.max_context = max_context
        self.block_size = int(block_size)
        if self.block_size:
            if max_context % self.block_size:
                raise ValueError(
                    f"max_context={max_context} must be a multiple of "
                    f"block_size={block_size} (gathered rows must tile "
                    f"exactly into the logical context)")
            self.blocks_per_slot = max_context // self.block_size
            self.n_blocks = n_slots * self.blocks_per_slot
            self.data = model.init_cache(self.n_blocks, self.block_size)
            self.block_table = np.full(
                (n_slots, self.blocks_per_slot), self.n_blocks, np.int32)
            self._free_blocks = list(range(self.n_blocks))
        else:
            self.blocks_per_slot = 0
            self.n_blocks = 0
            self.data = model.init_cache(n_slots, max_context)
            self.block_table = None
            self._free_blocks = []
        self.lengths = np.zeros(n_slots, np.int64)   # valid tokens per slot
        self._free = list(range(n_slots))
        self.owner: dict = {}                        # slot -> rid

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_free_blocks(self) -> int:
        return len(self._free_blocks)

    @property
    def free_slots(self):
        return sorted(self._free)

    def held_blocks(self, slot: int):
        """Physical blocks currently granted to ``slot`` (block mode)."""
        if self.block_table is None:
            return []
        row = self.block_table[slot]
        return [int(b) for b in row if b < self.n_blocks]

    def alloc(self, rid: int) -> int:
        """Claim the lowest free slot for ``rid``; resets its length."""
        if not self._free:
            raise RuntimeError("no free KV slots")
        self._free.sort()
        slot = self._free.pop(0)
        assert slot not in self.owner, f"slot {slot} double-booked"
        self.owner[slot] = rid
        self.lengths[slot] = 0
        return slot

    def ensure(self, slot: int, length: int) -> bool:
        """Grant blocks so ``slot`` can hold ``length`` positions.

        No-op in contiguous mode.  Block mode: lazily extends the slot's
        block-table row to cover ceil(length / block_size) logical blocks
        via the pure :func:`alloc_blocks` (lowest-free-first — so a single
        request admitted to an empty cache gets CONTIGUOUS physical blocks,
        the case the contiguous-equivalence test pins bit-identical).
        Returns True if the table changed.  Raises ``RuntimeError`` when
        the pool is exhausted.
        """
        if self.block_table is None:
            return False
        assert slot in self.owner, f"slot {slot} not allocated"
        assert length <= self.max_context
        have = len(self.held_blocks(slot))
        need = blocks_needed(length, self.block_size)
        if need <= have:
            return False
        grant, self._free_blocks = alloc_blocks(self._free_blocks,
                                                need - have)
        self.block_table[slot, have:need] = grant
        return True

    def release(self, slot: int) -> None:
        """Return a slot (and, block mode, every granted block) to the
        pool (its device rows are reused as-is)."""
        assert slot in self.owner, f"slot {slot} not allocated"
        del self.owner[slot]
        self.lengths[slot] = 0
        if self.block_table is not None:
            self._free_blocks = free_blocks(self._free_blocks,
                                            self.held_blocks(slot))
            self.block_table[slot] = self.n_blocks
        self._free.append(slot)
