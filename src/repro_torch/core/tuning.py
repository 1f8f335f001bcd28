"""Hardware-aware post-training weight tuning for the parallel architecture
(paper Section IV-B), the counterpart of ``tune_parallel`` in
``repro/core/tuning.py``.

``tune_parallel`` is a greedy hill-climber over *hardware* (integer)
accuracy on the validation split: repeatedly remove the least significant
nonzero CSD digit of every weight when accuracy does not drop (reduces
tnzd, hence the adder count of the shift-add realization), optionally
followed by a planner-priced polish (``cost="adders"``).

It runs on the batched hardware-accuracy engine (``repro_torch.eval``,
DESIGN.md 7) by default: the digit-drop loop follows the serial
accept/reject chain through each chunk with ``evaluate_chain``, and the
polish scores its alternatives with ``evaluate``, whose tail runs through
the ``csd_matvec`` kernel on the card.  Every accept/reject decision
reproduces the serial hill-climb exactly; ``engine="serial"`` keeps the
original per-candidate numpy loop.  The time-multiplexed tuner (IV-C) is
not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import csd
from .intmlp import IntMLP, hardware_accuracy

__all__ = ["tune_parallel", "TuneResult", "sls_of"]


@dataclass
class TuneResult:
    mlp: IntMLP
    bha: float                 # best hardware accuracy reached (validation, %)
    initial_ha: float
    replacements: int          # number of committed weight replacements
    sweeps: int                # full passes over the weights
    log: list = field(default_factory=list)
    stats: dict = field(default_factory=dict)  # evaluator counters (batched)


def _evaluator(x_val_int, y_val):
    def ev(mlp: IntMLP) -> float:
        return hardware_accuracy(mlp, x_val_int, y_val)
    return ev


def _batched_ev(mlp, x_val_int, y_val, backend, chunk, shard, device):
    from repro_torch.eval import BatchedHWEvaluator
    return BatchedHWEvaluator(mlp, x_val_int, y_val, backend=backend,
                              chunk=chunk, shard=shard, device=device)


# ---------------------------------------------------------------------------
# Section IV-B: parallel architecture — CSD digit removal
# ---------------------------------------------------------------------------

def tune_parallel(mlp: IntMLP, x_val_int: np.ndarray, y_val: np.ndarray,
                  *, max_sweeps: int = 50, engine: str = "batched",
                  cost: str = "tnzd", backend: str = "auto", chunk: int = 128,
                  shard: bool = False, planner=None,
                  device="cuda") -> TuneResult:
    """Greedy CSD-digit removal (paper IV-B).  ``engine="batched"`` scores
    candidate chunks on the repro_torch.eval engine, built on ``device``,
    with decisions identical to the serial loop; ``engine="serial"`` is the
    original reference path (numpy, on the host).

    ``cost`` selects the hardware-cost surface the accept loop climbs on
    (DESIGN.md 12.3):

    * ``"tnzd"`` (default) — the paper's proxy: any accuracy-neutral digit
      drop is accepted (each drop removes one nonzero CSD digit).
    * ``"adders"`` — planner-aware tuning, two phases.  Phase 1 is the
      paper's loop verbatim (identical decisions to ``cost="tnzd"``).
      Phase 2 then *polishes* on the priced cost surface: per weight it
      tries dropping ANY single CSD digit (least-significant first, the
      paper's move included), accepting the first alternative that keeps
      accuracy (``ha >= bha``) AND does not increase the touched layer's
      priced shift-add cost — its :class:`~repro_torch.core.planner.
      SynthesisPlanner` shared CMVM plan's adder count.  Cross-neuron CSE
      sharing makes that a genuinely different surface from tnzd (dropping
      a digit can break a shared subexpression and raise real adder
      counts).
      Only the touched layer is re-planned per accuracy-passing candidate;
      every other layer, repeat matrix, and the final pricing pass are
      planner memo hits.  Because phase 2 starts from the phase-1 (tnzd)
      result and every accept is vetoed against the priced cost, the final
      priced adder cost is monotonically non-increasing over polish
      accepts and never exceeds the tnzd engine's (both asserted in
      tests); ``TuneResult.stats`` carries the ``adders_initial`` /
      ``adders_after_drop`` / ``adders_final`` ledger plus the planner
      hit/miss counters, and polish sweeps continue the ``log`` numbering.

    ``planner`` (cost="adders" only) selects the plan cache.  The default is
    a RUN-LOCAL :class:`~repro_torch.core.planner.SynthesisPlanner`, so the
    polish phase's per-candidate plans never accumulate in the process-wide
    cache; pass a shared planner explicitly to keep repeat runs memo-served
    (the warm-rerun benchmark pattern) — accepting that its cache then
    holds one plan per accuracy-passing candidate matrix.
    """
    if cost not in ("tnzd", "adders"):
        raise ValueError(cost)
    if engine == "serial":
        return _tune_parallel_serial(mlp, x_val_int, y_val,
                                     max_sweeps=max_sweeps, cost=cost,
                                     planner=planner)
    if engine != "batched":
        raise ValueError(engine)
    from repro_torch.eval import Candidate
    if cost == "adders" and planner is None:
        from .planner import SynthesisPlanner
        planner = SynthesisPlanner()     # run-local: see docstring
    pstats0 = dict(planner.stats) if cost == "adders" else None
    ev = _batched_ev(mlp, x_val_int, y_val, backend, chunk, shard, device)
    bha = ev.accuracy()                             # step 1
    initial = bha
    replaced_total = 0
    sweeps = 0
    log = []
    # tnzd ledger (DESIGN.md 11.1): one array recoding up front, then the
    # paper's hardware-cost proxy is maintained through per-candidate nnz
    # deltas — no full recount per sweep (parity asserted in tests).
    tnzd0 = csd.tnzd(list(ev.mlp.weights) + list(ev.mlp.biases))
    tnzd_running = tnzd0
    adders0 = planner.cmvm_adder_cost(ev.mlp.weights) \
        if cost == "adders" else None
    while sweeps < max_sweeps:                      # step 3 loop
        sweeps += 1
        replaced_this_sweep = 0
        for k, w in enumerate(ev.mlp.weights):      # step 2: each weight != 0
            n_out = w.shape[1]
            flat = w.ravel()
            # Candidate values are fixed at layer entry: a commit only ever
            # rewrites the committed index itself, which is never revisited
            # this sweep, so the serial visit-time values are these.  One
            # whole-column array recoding yields every alternative value at
            # once (step 2a, vectorized).
            alts = csd.drop_least_significant_digit_array(flat)
            nz = np.nonzero(flat)[0]
            cands = [Candidate(k, int(idx) % n_out, int(idx) // n_out,
                               int(alts[idx])) for idx in nz]
            # Chain scan: one device call follows the serial greedy chain
            # through the whole chunk — candidate c is scored against the
            # prefix state with every earlier accept applied, so all chunk
            # decisions (step 2b) are made in one call, then committed in one
            # cache refresh.
            pos = 0
            while pos < len(cands):
                batch = cands[pos:pos + ev.chunk]
                flags, has = ev.evaluate_chain(batch, bha)
                for flag, ha in zip(flags, has):
                    if flag:
                        bha = ha                    # step 2b running best
                accepted = [c for c, flag in zip(batch, flags) if flag]
                if accepted:
                    ev.commit_many(accepted)
                    replaced_this_sweep += len(accepted)
                    # each accept drops exactly one nonzero CSD digit
                    tnzd_running -= len(accepted)
                pos += len(batch)
        replaced_total += replaced_this_sweep
        log.append((sweeps, replaced_this_sweep, bha))
        if replaced_this_sweep == 0:                # step 4
            break
    stats = dict(backend=ev.backend)
    if cost == "adders":                            # phase 2: planner polish
        adders_drop = planner.cmvm_adder_cost(ev.mlp.weights)
        bha, sweeps, polish_acc, polish_log = _adders_polish_batched(
            ev, bha, planner, max_sweeps, sweeps)
        replaced_total += polish_acc
        tnzd_running -= polish_acc
        log.extend(polish_log)
        stats.update(adders_initial=adders0, adders_after_drop=adders_drop,
                     adders_final=planner.cmvm_adder_cost(ev.mlp.weights),
                     planner_hits=planner.stats["hits"] - pstats0["hits"],
                     planner_misses=(planner.stats["misses"]
                                     - pstats0["misses"]))
    stats = dict(ev.stats, **stats, tnzd_initial=tnzd0,
                 tnzd_final=tnzd_running)
    return TuneResult(mlp=ev.mlp, bha=bha, initial_ha=initial,
                      replacements=replaced_total, sweeps=sweeps, log=log,
                      stats=stats)


def _polish_candidates(w: np.ndarray):
    """Phase-2 alternatives of a layer: for every nonzero weight (flat
    row-major order), every single-CSD-digit drop, least-significant digit
    first — ``(flat_idx, alternative)`` rows from one array recoding."""
    planes = csd.to_csd_array(w)                     # (D, n_in, n_out)
    p2 = np.moveaxis(planes, 0, -1).reshape(-1, planes.shape[0])  # (N, D)
    entries = np.argwhere(p2)                        # (idx asc, digit asc)
    if not len(entries):
        return []
    flat = w.ravel()
    idxs, digits = entries[:, 0], entries[:, 1]
    alts = flat[idxs] - (p2[idxs, digits].astype(np.int64) << digits)
    return list(zip(idxs.tolist(), alts.tolist()))


def _adders_polish_batched(ev, bha: float, planner, max_sweeps: int,
                           sweeps: int):
    """Planner-aware polish sweeps (phase 2 of ``cost="adders"``).

    Serial semantics: per weight, alternatives are tried in digit order and
    the FIRST one passing both gates (accuracy, priced layer cost) commits,
    skipping the weight's remaining alternatives.  Batching: alternatives
    are scored in independent evaluator chunks against the committed state —
    every score before the first accept is exactly the serial loop's, and an
    accept (rare by construction: the accuracy landscape is converged)
    commits immediately and re-scores the tail.  Planner synthesis runs only
    for accuracy-passing candidates; accepts never increase the priced cost.
    """
    from repro_torch.eval import Candidate
    accepted_total = 0
    polish_log = []
    polish = 0
    while polish < max_sweeps:
        polish += 1
        sweeps += 1
        replaced = 0
        for k, w in enumerate(ev.mlp.weights):
            n_out = w.shape[1]
            cl = _polish_candidates(w)
            layer_cost = planner.cmvm_adders(w)
            i = 0
            while i < len(cl):
                batch = cl[i:i + ev.chunk]
                cands = [Candidate(k, fi % n_out, fi // n_out, alt)
                         for fi, alt in batch]
                has = ev.evaluate(cands)
                advanced = None
                for j, ((fi, alt), c, ha) in enumerate(zip(batch, cands,
                                                           has)):
                    if ha < bha:
                        continue
                    new_w = ev.mlp.weights[k].copy()
                    new_w[c.row, c.col] = alt
                    new_cost = planner.cmvm_adders(new_w)
                    if new_cost > layer_cost:        # priced-cost veto
                        continue
                    ev.commit(c)                     # polish accept
                    bha = ha
                    layer_cost = new_cost
                    replaced += 1
                    accepted_total += 1
                    # skip this weight's remaining alternatives, then
                    # re-score the tail against the new committed state
                    jj = j + 1
                    while jj < len(batch) and batch[jj][0] == fi:
                        jj += 1
                    advanced = i + jj
                    break
                i = advanced if advanced is not None else i + len(batch)
                if advanced is not None:
                    while i < len(cl) and cl[i][0] == fi:
                        i += 1
        polish_log.append((sweeps, replaced, bha))
        if replaced == 0:
            break
    return bha, sweeps, accepted_total, polish_log


def _tune_parallel_serial(mlp: IntMLP, x_val_int: np.ndarray,
                          y_val: np.ndarray, *, max_sweeps: int = 50,
                          cost: str = "tnzd", planner=None) -> TuneResult:
    stats = {}
    if cost == "adders" and planner is None:
        from .planner import SynthesisPlanner
        planner = SynthesisPlanner()                # run-local (see batched)
    if cost == "adders":
        pstats0 = dict(planner.stats)
        stats["adders_initial"] = planner.cmvm_adder_cost(mlp.weights)
    ev = _evaluator(x_val_int, y_val)
    mlp = mlp.copy()
    bha = ev(mlp)                                   # step 1
    initial = bha
    replaced_total = 0
    sweeps = 0
    log = []
    while sweeps < max_sweeps:                      # step 3 loop
        sweeps += 1
        replaced_this_sweep = 0
        for k, w in enumerate(mlp.weights):         # step 2: each weight != 0
            flat = w.ravel()
            for idx in range(flat.size):
                v = int(flat[idx])
                if v == 0:
                    continue
                alt = csd.drop_least_significant_digit(v)   # step 2a
                flat[idx] = alt
                ha = ev(mlp)
                if ha >= bha:                        # step 2b
                    bha = ha
                    replaced_this_sweep += 1
                else:
                    flat[idx] = v                    # revert
        replaced_total += replaced_this_sweep
        log.append((sweeps, replaced_this_sweep, bha))
        if replaced_this_sweep == 0:                 # step 4
            break
    if cost == "adders":                             # phase 2: planner polish
        stats["adders_after_drop"] = planner.cmvm_adder_cost(mlp.weights)
        polish = 0
        while polish < max_sweeps:
            polish += 1
            sweeps += 1
            replaced = 0
            for k, w in enumerate(mlp.weights):
                flat = w.ravel()
                layer_cost = planner.cmvm_adders(w)
                for idx in range(flat.size):
                    v = int(flat[idx])
                    if v == 0:
                        continue
                    for p, dgt in enumerate(csd.to_csd(v)):
                        if dgt == 0:
                            continue
                        flat[idx] = v - (dgt << p)   # drop ANY single digit
                        ha = ev(mlp)
                        ok = ha >= bha
                        if ok:
                            new_cost = planner.cmvm_adders(w)
                            ok = new_cost <= layer_cost
                        if ok:
                            bha = ha
                            layer_cost = new_cost
                            replaced += 1
                            replaced_total += 1
                            break                    # next weight
                        flat[idx] = v                # revert, next digit
            log.append((sweeps, replaced, bha))
            if replaced == 0:
                break
        stats.update(
            adders_final=planner.cmvm_adder_cost(mlp.weights),
            planner_hits=planner.stats["hits"] - pstats0["hits"],
            planner_misses=planner.stats["misses"] - pstats0["misses"])
    return TuneResult(mlp=mlp, bha=bha, initial_ha=initial,
                      replacements=replaced_total, sweeps=sweeps, log=log,
                      stats=stats)


def sls_of(values) -> int:
    """Smallest left shift among a set of integer weights (zeros ignored)."""
    v = np.asarray(values, dtype=np.int64).ravel()
    v = v[v != 0]
    return int(csd.largest_left_shift_array(v).min()) if v.size else 0
